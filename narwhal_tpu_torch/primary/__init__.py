"""The primary: DAG construction protocol (headers, votes, certificates).

Port copy of `narwhal_tpu/primary/__init__.py` (the JAX package's counterpart). The
PyTorch port keeps its own copy so that it imports nothing of `narwhal_tpu`.

Reference crate: narwhal/primary/ (see SURVEY §2.8).
"""

from .aggregators import CertificatesAggregator, VotesAggregator
from .certificate_waiter import CertificateWaiter
from .core import Core
from .header_waiter import HeaderWaiter
from .helper import Helper
from .metrics import PrimaryMetrics
from .payload_receiver import PayloadReceiver
from .primary import Primary
from .proposer import NetworkModel, Proposer
from .state_handler import StateHandler
from .synchronizer import SyncBatches, SyncParents, Synchronizer

__all__ = [
    "CertificateWaiter",
    "CertificatesAggregator",
    "Core",
    "HeaderWaiter",
    "Helper",
    "NetworkModel",
    "PayloadReceiver",
    "Primary",
    "PrimaryMetrics",
    "Proposer",
    "StateHandler",
    "SyncBatches",
    "SyncParents",
    "Synchronizer",
    "VotesAggregator",
]
