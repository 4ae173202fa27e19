"""Host-side pieces of the reference's `core` package that the slot
engine's lowering needs (NumPy only)."""
