"""Device-side operations: epilogue fusion and the hand-written kernels."""
