"""The frames axis across devices: frame batches split into one share
per device, every share through the same encode and decode on its own
device, the results gathered in order (the port of alacjax/parallel/).
The codec is per-frame-lane pure, so no device talks to another except
to scatter the input and gather the output; the packets' byte count is
the one sum taken across devices."""

from .sharding import ShardedCodec, frame_mesh

__all__ = ["ShardedCodec", "frame_mesh"]
