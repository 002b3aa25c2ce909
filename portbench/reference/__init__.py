"""Plain references of what the program computes, one module a semantics,
named by a configuration's `reference` key.  They import neither the
program nor JAX."""
