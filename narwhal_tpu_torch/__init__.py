"""narwhal_tpu_torch — the PyTorch and CUDA port of `narwhal_tpu`.

A second package beside the JAX one (`narwhal_tpu/`, the reference the port
is held against by the parity tests in `tests/test_torch_*.py`). It imports
`torch` and numpy and never `jax` or anything of `narwhal_tpu`: the host
modules it needs are its own copies, and its device plane `gpu/` (the
counterpart of `narwhal_tpu/tpu/`) runs hand-written CUDA kernels for
Hopper (`gpu/csrc/`) with a plain PyTorch version beside each one.

Ported so far: the certificate path of a device-backed node, in both wire
forms — ed25519 item verification and the compact-certificate msm lanes
(`gpu.verifier`), the device DAG window (place / roll) and the
Bullshark / Tusk chain commit walk (`gpu.dag_kernels.GpuBullshark`,
`GpuTusk`), composed by `gpu.pipeline.FusedCertificatePipeline`; and the
external-consensus Dag service (`consensus.Dag`), whose concurrent causal
reads run as one batched reach walk on the card (`gpu.dag_kernels.
reach_many`), with the host engines `consensus.Bullshark` and `Tusk`.
"""

__version__ = "0.1.0"
