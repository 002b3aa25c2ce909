"""The reference's MPI chain partitioning on one card (chainpart.py)."""
