"""The harness's shared parts: the scene, the trace, the recorded calls."""
