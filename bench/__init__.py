"""The benchmark of the PyTorch/CUDA port: full-width training steps on one
H100, judged against a plain fp32 reference. ``python3 bench/run.py --help``
runs one cell; README.md says how to add a configuration, a traffic mix, a
cell or a per-layer metric as new files only."""
