"""The benchmark's harness: cells by name, traffic, seeded weights, the
measured window, the trace reduction, the yardstick's counts and the
comparison that decides ``correct``. It imports the port only where it
builds and drives the system under test."""
