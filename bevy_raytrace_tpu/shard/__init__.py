from bevy_raytrace_tpu.shard.mesh import make_mesh, initialize_multihost
from bevy_raytrace_tpu.shard.render_sharded import (
    render_sharded,
    make_sharded_renderer,
)

__all__ = [
    "make_mesh",
    "initialize_multihost",
    "render_sharded",
    "make_sharded_renderer",
]
