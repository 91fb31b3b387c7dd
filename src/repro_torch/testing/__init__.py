"""Test support for the port: ``schedules``, the schedule-exploring
linearizability and crash-recovery harness (the port of
``repro.testing.schedules``), and ``proptest``, the seeded stand-in for
the part of hypothesis its property suites use. Importing this package
loads neither."""
