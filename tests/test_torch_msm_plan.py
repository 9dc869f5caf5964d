"""The launch plan of the window-lane accumulate kernels (A2 `msm_accumulate`,
A6 `msm_window`, `csrc/ed25519_msm.cu`), on the CPU.

The geometry lives in the wrapper (`ed25519.msm_plan`): one CTA per chain,
4 threads per window lane, each CTA's rows in tiles of shared memory. For
every bucket the wrappers accept (`_check_chains`: 16 .. 8192) and each lane
layout the kernels are built for (A6's 32 and 64 lanes, A2's 64 + 32), the
plan must add every row exactly once, chain c taking rows c, c + C, c + 2C,
... in that order (the JAX `_accumulate_windows` order, which decides the
lanes of invalid points), and fit a CTA's 232,448 bytes of shared memory.
"""

import pytest

from narwhal_tpu_torch.gpu import ed25519 as tk

LAYOUTS = {"A6 32 lanes": (32, 0), "A6 64 lanes": (64, 0), "A2 96 lanes": (64, 32)}


def _accepted_buckets():
    out = []
    for B in range(16, 8193):
        try:
            tk._check_chains("msm_window", B)
        except ValueError:
            continue
        out.append(B)
    return out


BUCKETS = _accepted_buckets()


def test_accepted_buckets_are_the_verifier_shapes():
    assert BUCKETS[:4] == [16, 32, 64, 128] and BUCKETS[-1] == 8192
    assert all(B % 128 == 0 for B in BUCKETS[3:])
    assert {512, 1024, 2048, 8192} <= set(BUCKETS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_adds_every_row_once_in_chain_order(layout):
    wa, wr = LAYOUTS[layout]
    for B in BUCKETS:
        plan = tk.msm_plan("msm_window", B, wa, wr)
        C = plan["ctas"]
        assert C == min(128, B) and plan["threads"] == 4 * (wa + wr) <= 1024
        seen = []
        for c in range(C):
            tiles = tk.msm_plan_rows(plan, c)
            assert len(tiles) == plan["tiles"]
            assert all(1 <= len(t) <= plan["tile"] for t in tiles)
            rows = [j for t in tiles for j in t]
            # chain c: its rows, in the order the JAX scan adds them
            assert rows == list(range(c, B, C)), (B, c)
            seen += rows
        assert sorted(seen) == list(range(B)), B


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_fits_shared_memory(layout):
    wa, wr = LAYOUTS[layout]
    for B in BUCKETS:
        plan = tk.msm_plan("msm_window", B, wa, wr)
        assert plan["smem"] == tk.msm_smem_bytes(plan["tile"], wa, wr)
        assert plan["smem"] + tk.MSM_STATIC_SMEM <= 232448, (B, plan)
        # a tile is the whole chain unless that would not fit, then as large
        # as halving allows
        S = plan["rows_per_chain"]
        if plan["tile"] < S:
            assert tk.msm_smem_bytes(2 * plan["tile"], wa, wr) + tk.MSM_STATIC_SMEM > 232448


def test_plan_tiles_at_the_main_path_shapes():
    """B = 2048 (the verifier's bucket) is one tile in every layout; at B =
    8192 (the largest bucket) A2's 64 rows a chain take two tiles of 32."""
    for wa, wr in LAYOUTS.values():
        plan = tk.msm_plan("msm_accumulate", 2048, wa, wr)
        assert (plan["ctas"], plan["rows_per_chain"], plan["tiles"]) == (128, 16, 1)
    a2 = tk.msm_plan("msm_accumulate", 8192, 64, 32)
    assert (a2["tile"], a2["tiles"], a2["smem"]) == (32, 2, 32 * (2 * 2564 + 96))
    a6 = tk.msm_plan("msm_window", 8192, 64)
    assert (a6["tile"], a6["tiles"]) == (64, 1)
    small = tk.msm_plan("msm_window", 16, 32)
    assert (small["ctas"], small["tile"], small["tiles"]) == (16, 1, 1)


def test_plan_refuses_what_the_chains_refuse():
    for B in (0, 24, 200, 8200):
        with pytest.raises(ValueError, match="chains"):
            tk.msm_plan("msm_window", B, 64)
