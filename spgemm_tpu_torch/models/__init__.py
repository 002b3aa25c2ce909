"""Models of the port: the block-sparse FFN (models/ffn.py)."""
