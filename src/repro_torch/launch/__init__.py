"""The port's entry points, run as modules: ``serve`` (LM decode
co-hosted with graph traffic, ``python -m repro_torch.launch.serve``),
``durable_serve`` (WAL-backed graph serving with crash and recovery,
``python -m repro_torch.launch.durable_serve``), ``train`` (the LM
training launcher, ``python -m repro_torch.launch.train``) and ``dryrun``
(every arch x shape x mesh cell traced on fake ranks, ``python -m
repro_torch.launch.dryrun``); and the pieces they share: ``steps`` (the
train, prefill and decode steps) and ``mesh`` (the production and host
meshes)."""
