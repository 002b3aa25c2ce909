"""PyTorch/CUDA port of spgemm_tpu: the block-sparse uint64 matrix chain
product with the reference's wrap-then-mod fold, on an NVIDIA H100.

Main path: cli.run -> utils/io_text.read_chain -> chain.chain_product ->
ops/spgemm.spgemm_device (ops/symbolic planning, on chain.py's planner
thread; the CUDA numeric kernel in ops/cuda_spgemm.py +
csrc/numeric_round.cu, one assembly gather) -> BlockSparseMatrix.prune_zeros
-> io_text.write_matrix.  The text reader and writer and the symbolic join
run in the native host library (utils/native.py + native/*.cpp, built with
g++ at first use); plans are memoized by structure (ops/plancache.py).  The
CLI's other modes: parallel/chainpart.py (--ranks), ops/spgemm.spgemm and
spgemm_outofcore (--stream, --out-of-core), utils/checkpoint.py
(--checkpoint-dir), utils/backend_probe.py and chain.py's failover
(--failover).

Imports torch and numpy only: never jax and nothing of spgemm_tpu.
"""
