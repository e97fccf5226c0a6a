"""The benchmark's yardstick: the input generator, the plain reference
searches, Graph500's rules, the profiler arithmetic and the H100's peaks.
Plain PyTorch; nothing here imports `jax`, `repro` or `repro_torch`."""
