"""The plain fp32 reference of the benchmark's training cells."""
