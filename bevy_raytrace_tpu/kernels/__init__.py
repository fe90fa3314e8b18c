from bevy_raytrace_tpu.kernels.trace_gpu import render_pallas

__all__ = ["render_pallas"]
