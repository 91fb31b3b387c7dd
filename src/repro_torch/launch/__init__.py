"""The port's entry points, run as modules: ``durable_serve`` (WAL-backed
graph serving with crash and recovery, ``python -m
repro_torch.launch.durable_serve``)."""
