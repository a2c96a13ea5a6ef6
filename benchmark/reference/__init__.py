"""The plain reference: float32 PyTorch, with no kernel and nothing of the
program under test."""
