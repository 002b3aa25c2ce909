"""Block structures of the leaves, one module a kind, named by a configuration's
`structure.kind`: build(params) -> one (n, 2) int64 coordinate array a leaf."""
