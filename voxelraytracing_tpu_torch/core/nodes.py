"""SVO node bit format.

A node is a 16-bit value (reference: common/src/world/mod.rs:150-194):

  * ``0xxxxxxxxxxxxxxx`` — leaf: the whole node is occupied by voxel ``x``.
  * ``1yyyyyyyyyyyyyyy`` — split: the node's 8 half-size children are stored
    contiguously starting at node index ``y`` (chunk-relative).

Port of ``voxelraytracing_tpu/core/nodes.py``. Nodes are widened to
``int32`` (value range 0..65535) in arrays and tensors, as in the JAX
package; the 16-bit *format* is preserved exactly, and serialization uses
``uint16``.

All helpers below are dtype-polymorphic: they work on Python ints, NumPy
arrays and torch tensors.
"""

SPLIT_MASK = 0x8000
DATA_MASK = 0x7FFF

EMPTY_NODE = 0  # leaf node holding voxel 0 ("air")


def leaf(voxel):
    """Node occupied entirely by ``voxel``."""
    return voxel & DATA_MASK


def split(child_idx):
    """Node that splits into 8 children stored contiguously at ``child_idx``."""
    return child_idx | SPLIT_MASK


def is_split(node):
    return (node & SPLIT_MASK) != 0


def voxel_of(node):
    """Voxel id of a leaf node (low 15 bits)."""
    return node & DATA_MASK


def child_idx_of(node):
    """First-child index of a split node (low 15 bits)."""
    return node & DATA_MASK
