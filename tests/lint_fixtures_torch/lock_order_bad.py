"""Deliberate entity-lock discipline violations (lint fixture)."""
import threading


class NotTheTable:
    def __init__(self):
        self.lk = threading.Lock()  # LINT-EXPECT: lock-order

    def grab(self):
        self.lk.acquire()  # LINT-EXPECT: lock-order

    def drop(self):
        self.lk.release()  # LINT-EXPECT: lock-order


class EntityLockTable:
    """Same name as the port's table: its own sites are exempt."""

    def __init__(self):
        self._guard = threading.Lock()

    def try_one(self, lk):
        return lk.acquire(blocking=False)
