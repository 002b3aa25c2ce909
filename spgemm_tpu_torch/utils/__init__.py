"""Host-side utilities: container, text I/O, generators, oracle, timers."""
