"""Suppressed lock-order violation (lint fixture)."""
import threading


class Harness:
    def __init__(self):
        # module guard, not an entity lock
        self.mu = threading.Lock()  # repro-torch-lint: allow(lock-order)
