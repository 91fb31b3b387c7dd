"""The port's entry points, run as modules: ``serve`` (LM decode
co-hosted with graph traffic, ``python -m repro_torch.launch.serve``) and
``durable_serve`` (WAL-backed graph serving with crash and recovery,
``python -m repro_torch.launch.durable_serve``)."""
