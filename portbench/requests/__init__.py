"""Requests of traffic, one module a kind, named by a mix's `request`:
make(config, mix, device) -> the inputs (with `jobs`, draw(seed, request),
tiles(job) for the reference and work() for the roofline), and
call(inputs, device, backend) -> [(coords, tiles without the sentinel)],
one a chain."""
