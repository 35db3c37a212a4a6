"""The benchmark of svsdf_tpu_torch on the H100: ``python3 -m benchmark.run``
(see run.py) and the files it reads by name."""
