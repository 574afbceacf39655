"""Checkpoints: the reference's CRC32 checkpoint store over torch tensors."""
from .store import (CheckpointManager, LeafMismatch,  # noqa: F401
                    load_pytree, save_pytree, tree_flatten, tree_unflatten)
