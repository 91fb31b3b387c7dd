"""Test support for the port: ``schedules``, the schedule-exploring
linearizability and crash-recovery harness (the port of
``repro.testing.schedules``). Importing this package loads none of it."""
