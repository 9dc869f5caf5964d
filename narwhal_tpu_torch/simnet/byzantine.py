"""Byzantine equivocator — a validator that signs conflicting headers.

Port copy of `narwhal_tpu/simnet/byzantine.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

The adversary is a REAL node: it holds its own protocol keypair and uses it
to produce, for every round it proposes in, a second validly-signed header
(the "twin") that conflicts with the one its own core processes. The twin
is pushed as a full `HeaderMsg` by direct reliable send to half the
committee (every node accepts the full form regardless of its own
`header_wire` setting), while the ordinary broadcast path disseminates the
original — so different honest nodes may see the two conflicting headers in
either order.

Twin construction keeps the header *votable* when possible: if the parent
set has slack above the quorum threshold, the twin simply omits one parent
(a perfectly valid header with a different digest). With no slack it
carries a fabricated payload digest instead — still signed, still
conflicting, but honest nodes will never complete its payload sync.

What the protocol must guarantee (and the simnet safety oracle asserts):
the per-(author, round) vote-once rule means the author's implicit stake is
the only stake both twins share, so at most one of the two can ever reach a
quorum certificate — no two honest nodes commit conflicting sequences, with
or without the equivocator's slot filled.
"""

from __future__ import annotations

import logging

from ..crypto import digest256
from ..messages import HeaderMsg
from ..types import Header

logger = logging.getLogger("narwhal.simnet.byzantine")


class Equivocator:
    """Installed over a started node's core: wraps `process_own_header`."""

    def __init__(self, details, fixture_auth, committee):
        self._core = details.primary.primary.core
        self._network = details.primary.primary.network
        self._keypair = fixture_auth.keypair
        self._name = fixture_auth.public
        self._committee = committee
        self._orig = self._core.process_own_header
        self._core.process_own_header = self._process_own_header
        self.twins_sent = 0
        self.twin_digests: list[tuple[int, str, str]] = []  # (round, A, B)
        self._handles = []

    def _build_twin(self, header: Header) -> Header:
        parents = sorted(header.parents)
        # Stake-based count of parents a valid header can stand on: with
        # equal-stake fixtures this is the number of parent certificates a
        # quorum requires.
        if len(parents) > self._committee.quorum_threshold():
            twin_parents = frozenset(parents[1:])
            payload = dict(header.payload)
        else:
            twin_parents = header.parents
            payload = dict(header.payload)
            salt = digest256(
                b"EQUIVOCATE" + header.round.to_bytes(8, "little")
            )
            payload[salt] = 0
        return Header.build(
            self._name,
            header.round,
            header.epoch,
            payload,
            set(twin_parents),
            self._keypair,
        )

    async def _process_own_header(self, header: Header) -> None:
        twin = self._build_twin(header)
        if twin.digest != header.digest:
            msg = HeaderMsg(twin)
            others = self._committee.others_primaries(self._name)
            victims = others[::2]  # deterministic half of the committee
            for _, address, _ in victims:
                self._handles.append(self._network.send(address, msg))
            self.twins_sent += len(victims)
            self.twin_digests.append(
                (header.round, header.digest.hex(), twin.digest.hex())
            )
            logger.debug(
                "equivocated round %d: %s vs %s to %d peers",
                header.round, header.digest.hex()[:12],
                twin.digest.hex()[:12], len(victims),
            )
            # Completed reliable-send handles are dropped; live ones stay
            # referenced so the retry tasks are cancellable at teardown.
            self._handles = [h for h in self._handles if not h.task.done()]
        await self._orig(header)

    def uninstall(self) -> None:
        self._core.process_own_header = self._orig
        for h in self._handles:
            h.cancel()
        self._handles.clear()
