"""Loops of traffic, one module a kind, named by a mix's `loop`:
run(driver, seed, seconds, reservoir, spans) -> harness.Loop."""
