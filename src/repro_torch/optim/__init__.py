"""The port's optimizer (``adamw``), its error-feedback gradient
compression (``grad_compress``) and LR schedules (``schedule``); the port
of ``repro.optim``. Plain torch arithmetic, as JAX's is plain ``jnp``."""
from repro_torch.optim import adamw, grad_compress, schedule  # noqa: F401
