"""The sharded walk's plain version against the JAX package, its route
selection, and its compositions on every route, on the CPU.

- `sharded_walk_plain` over auth in {1, 2, 4} column blocks (N = 4 divides
  every auth, N = 7 pads to 8) against the JAX `chain_commit` (chain mode,
  K = 1, 2, 4 with an all-zero slot at K = 4) and against `reach_mask`
  vmapped over the walks as `narwhal_tpu/consensus/dag.py` `_reach_k` does
  (many mode), on the same numpy inputs: bit-exact;
- `mesh.walk_route` with `torch.cuda.can_device_access_peer` and the
  device count monkeypatched: a repeated card is "cluster", distinct cards
  with access "peer", without it "host", and more shards on one card
  than a cluster holds is a ConfigError (a CPU mesh takes any number);
  the "host" route's launch groups (one a card, one a slot on a card
  repeated) with no peer mapping;
- `chain_commit_sharded`, `reach_many_sharded` and
  `consensus_step_sharded` forced onto the "cluster" and "host" routes
  over `["cpu"] * k` meshes (the plain version walks the CPU's one group),
  against the unsharded plain versions: exact; "peer" forced on CPU
  devices is a ConfigError (the peer exchange has no plain form: it runs
  on the card only).

The kernel itself runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it to this plain version there.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from narwhal_tpu.tpu import dag_kernels as jd
from narwhal_tpu_torch.config import ConfigError
from narwhal_tpu_torch.gpu import dag_kernels as td
from narwhal_tpu_torch.gpu import mesh as tmesh
from narwhal_tpu_torch.gpu.mesh import WalkExchange, auth_mesh

W, GC = 16, 4


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _walk(auth, parent, present, lc, offs, onehots, gc, lcr, chain):
    """sharded_walk (the plain version, CPU tensors) over `auth` blocks, as
    [K, W, N]."""
    n = present.shape[1]
    pb, qb, lb, oh = chip_smoke.walk_blocks(auth, parent, present, lc, onehots)
    masks = td.sharded_walk(*_t(pb, qb, lb, offs, oh), gc, lcr, chain)
    assert tuple(masks.shape) == (auth, offs.shape[0], W, -(-n // auth))
    return chip_smoke.unblock(masks, n).numpy()


@pytest.mark.parametrize("n,K,live", [(4, 1, 1), (4, 2, 2), (4, 4, 3), (7, 1, 1), (7, 2, 2),
                                      (7, 4, 3)])
def test_sharded_walk_plain_chain_matches_jax_chain_commit(n, K, live):
    """Healed-partition chains where the gc filter bites and lcr advances
    between leaders; at K = 4 the last slot's one-hot is all zero."""
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        np.random.default_rng(10 * n + K), W, n, GC, K, live)
    want = np.asarray(jd.chain_commit(parent, present, np.int32(GC), lc, np.int32(lcr), offs,
                                      onehots))
    assert want[:live].any() and not want[live:].any()
    for auth in (1, 2, 4):
        assert np.array_equal(_walk(auth, parent, present, lc, offs, onehots, GC, lcr, True),
                              want), auth


@pytest.mark.parametrize("n", [4, 7])
def test_sharded_walk_plain_many_matches_jax_vmapped_reach_mask(n):
    parent, present, offs, onehots = chip_smoke.reach_many_inputs(
        np.random.default_rng(n), W, n, 8, 6)
    reach_k = jax.jit(jax.vmap(jd.reach_mask, in_axes=(None, None, 0, 0)))
    want = np.asarray(reach_k(parent, present, offs, onehots))
    assert want[:6].any() and not want[6:].any()
    for auth in (1, 2, 4):
        got = _walk(auth, parent, present, None, offs, onehots, 0, -(2**30), False)
        assert np.array_equal(got, want), auth


# -- the route, from the topology --------------------------------------------


@pytest.fixture
def cards(monkeypatch):
    """Pretend to have `n` cards with the given peer access: returns a
    setter `(n, access)` where access(a, b) says whether a reaches b."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def set_cards(n, access):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                            lambda a, b: access(torch.device(a).index, torch.device(b).index))
    return set_cards


def test_route_is_cluster_on_a_repeated_card(cards):
    cards(1, lambda a, b: False)
    mesh = auth_mesh(2, devices=["cuda:0", "cuda:0"])
    assert mesh.routes == ["cluster"]
    assert mesh.walk().groups == [[0, 1]] and mesh.walk().devices == [torch.device("cuda", 0)]
    # "peer" forced on the repeated card: a launch per slot.
    assert mesh.walk(0, "peer").groups == [[0], [1]]
    assert auth_mesh(4, devices=["cpu"] * 4).routes == ["cluster"]


def test_route_is_peer_across_cards_with_access(cards):
    cards(4, lambda a, b: True)
    assert auth_mesh(2).routes == ["peer"]
    mesh = auth_mesh(2, data=2)
    assert mesh.routes == ["peer", "peer"] and mesh.walk(1).groups == [[0], [1]]
    two = auth_mesh(4, devices=["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert two.routes == ["peer"] and two.walk().groups == [[0, 2], [1, 3]]


def test_route_is_host_across_cards_without_access(cards):
    cards(2, lambda a, b: False)
    assert auth_mesh(2).routes == ["host"]
    cards(2, lambda a, b: a == 0)  # one direction only
    mesh = auth_mesh(2)
    assert mesh.routes == ["host"] and mesh.walk().groups == [[0], [1]]
    with pytest.raises(ConfigError):  # a row over two cards is no cluster
        mesh.walk(0, "cluster")
    with pytest.raises(ConfigError):  # nor a peer route without access
        mesh.walk(0, "peer")
    # A card's shards of the row form one cluster on "host" too.
    k = tmesh.MAX_CLUSTER
    assert tmesh.walk_route([torch.device(d) for d in ["cuda:0"] * k + ["cuda:1"]]) == "host"
    with pytest.raises(ConfigError):
        tmesh.walk_route([torch.device(d) for d in ["cuda:0"] * (k + 1) + ["cuda:1"]])
    with pytest.raises(ConfigError):  # the CPU and a card in one row
        auth_mesh(2, devices=["cpu", "cuda:0"])


def test_host_exchange_groups_without_peer_mapping(cards, monkeypatch):
    """WalkExchange(..., "host"): one launch group per card, one per slot
    on a card repeated, a card's slots together on a row over cards
    repeated; on a CPU row one group (the plain version). Building it, and
    forcing it where the cards have peer access, maps no pair of cards:
    its buffers are host memory."""
    from narwhal_tpu_torch.gpu import kernel_registry

    def no_library(stem):
        raise AssertionError(f"the host route's groups loaded {stem}: no peer mapping")
    monkeypatch.setattr(kernel_registry, "library", no_library)
    cards(4, lambda a, b: False)
    dev = (lambda *i: [torch.device("cuda", j) for j in i])
    two = WalkExchange(dev(0, 1), "host")
    assert two.groups == [[0], [1]] and two.devices == dev(0, 1)
    assert WalkExchange(dev(0, 0, 0), "host").groups == [[0], [1], [2]]
    spread = WalkExchange(dev(0, 1, 0, 1), "host")
    assert spread.groups == [[0, 2], [1, 3]] and spread.devices == dev(0, 1)
    assert auth_mesh(4, devices=["cuda:2"] * 4).walk(0, "host").groups == [[0], [1], [2], [3]]
    cards(4, lambda a, b: True)  # forced where the cards have peer access
    mesh = auth_mesh(2, devices=["cuda:0", "cuda:1"])
    assert mesh.routes == ["peer"] and mesh.walk(0, "host").groups == [[0], [1]]
    assert mesh.walk(0, "host") is mesh.walk(0, "host")  # kept on the mesh
    cpu = WalkExchange([torch.device("cpu")] * 3, "host")
    assert cpu.groups == [[0, 1, 2]] and cpu.devices == [torch.device("cpu")]


def test_cluster_size_above_the_limit_raises(cards):
    cards(2, lambda a, b: True)
    k = tmesh.MAX_CLUSTER
    assert auth_mesh(k, devices=["cuda:0"] * k).routes == ["cluster"]
    with pytest.raises(ConfigError):
        auth_mesh(k + 1, devices=["cuda:0"] * (k + 1))
    with pytest.raises(ConfigError):
        auth_mesh(2 * k + 2, devices=["cuda:0", "cuda:1"] * (k + 1))
    with pytest.raises(ConfigError):
        auth_mesh(2, devices=["cpu"] * 2).walk(0, "ring")


# -- the compositions on every route -----------------------------------------


@pytest.mark.parametrize("route", ["cluster", "peer", "host"])
@pytest.mark.parametrize("auth,n", [(2, 4), (4, 7)])
def test_sharded_compositions_on_each_route(route, auth, n):
    """Each composition forced onto `route` over a CPU mesh equals the
    unsharded plain version; "peer", the card's exchange, has no plain form
    and is refused on CPU devices."""
    mesh = auth_mesh(auth, devices=["cpu"] * auth)
    grid = auth_mesh(auth, devices=["cpu"] * (2 * auth), data=2)
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        np.random.default_rng(auth + n), W, n, GC, 4, 3)
    rin = chip_smoke.reach_many_inputs(np.random.default_rng(n), W, n, 8, 6)
    step = chip_smoke.support_inputs(np.random.default_rng(n), W, n, 8, 0.5)
    if route == "peer":
        for call in (lambda: td.chain_commit_sharded(mesh, parent, present, GC, lc, lcr, offs,
                                                     onehots, route=route),
                     lambda: td.reach_many_sharded(mesh, *rin, route=route),
                     lambda: td.consensus_step_sharded(grid, *step, route=route)):
            with pytest.raises(ConfigError, match="cards only"):
                call()
        return
    want = td.chain_commit_plain(*_t(parent, present), GC, *_t(lc), lcr, *_t(offs, onehots))
    got = td.chain_commit_sharded(mesh, parent, present, GC, lc, lcr, offs, onehots,
                                  route=route)
    assert torch.equal(got, want) and bool(want.any())
    want = td.reach_many_plain(*_t(*rin))
    assert torch.equal(td.reach_many_sharded(mesh, *rin, route=route), want)
    assert tuple(td.reach_many_sharded(mesh, rin[0], rin[1], rin[2][:0], rin[3][:0],
                                       route=route).shape) == (0, W, n)
    flat = td.consensus_step(*_t(*step))
    for a, b in zip(td.consensus_step_sharded(grid, *step, route=route), flat):
        assert torch.equal(a, b)


def test_cpu_mesh_takes_any_shard_count():
    """More shards on one CPU device than a cluster holds: the "cluster"
    route, walked by the plain version (no cluster limit off the card), as
    the JAX package takes any auth count."""
    k = tmesh.MAX_CLUSTER + 1
    mesh = auth_mesh(k, devices=["cpu"] * k)
    assert mesh.routes == ["cluster"]
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        np.random.default_rng(17), W, 7, GC, 2, 2)
    want = td.chain_commit_plain(*_t(parent, present), GC, *_t(lc), lcr, *_t(offs, onehots))
    assert torch.equal(td.chain_commit_sharded(mesh, parent, present, GC, lc, lcr, offs,
                                               onehots), want) and bool(want.any())
    rin = chip_smoke.reach_many_inputs(np.random.default_rng(17), W, 7, 8, 6)
    assert torch.equal(td.reach_many_sharded(mesh, *rin), td.reach_many_plain(*_t(*rin)))


def test_peer_form_refuses_cpu_tensors(cards):
    """sharded_walk with an exchange ("peer" or "host") takes card tensors
    only: on CPU tensors it raises rather than walk a plain stand-in."""
    cards(2, lambda a, b: True)
    parent, present, lc, lcr, offs, onehots = chip_smoke.healed_partition_chain(
        np.random.default_rng(5), W, 4, GC, 2, 2)
    pb, qb, lb, oh = _t(*chip_smoke.walk_blocks(4, parent, present, lc, onehots))
    for route in ("peer", "host"):
        ex = WalkExchange([torch.device("cuda", i % 2) for i in range(4)], route)
        assert ex.groups == [[0, 2], [1, 3]]
        cut = (lambda t: [t[g] for g in ex.groups])
        with pytest.raises(ValueError, match=f"{route} form runs on the card only"):
            td.sharded_walk(cut(pb), cut(qb), cut(lb), [torch.from_numpy(offs)] * 2, [oh] * 2,
                            GC, lcr, True, exchange=ex)
