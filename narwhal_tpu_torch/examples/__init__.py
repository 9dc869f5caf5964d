"""Demo clients of the port's external-consensus public API.

Port copies of the repo's `examples/demo_client.py` (the typed RPC) and
`examples/grpc_demo_client.py` (gRPC). Run either with
`python -m narwhal_tpu_torch.examples.<name>`.
"""
