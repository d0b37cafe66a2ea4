"""The dense float64 oracle: explicit element matrices, no sum
factorisation (``assemble``)."""
