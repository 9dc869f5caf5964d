"""Operator tools of the port: the metrics catalog, the simnet profiler and
the device-plane epilogue attributor.

Port copies of the repo's `tools/metrics_catalog.py`,
`tools/perf/simnet_profile.py` and `tools/perf/epilogue.py`. Run each with
`python -m narwhal_tpu_torch.tools.<name>`.
"""
