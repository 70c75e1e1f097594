"""Scene graphs, SDF primitives and combinators, and the kernel code generator."""
