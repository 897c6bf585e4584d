"""The benchmark of the PyTorch/CUDA port, ``repro_torch``, on NVIDIA H100s.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
harness is driven by data: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``, whose
``kind`` names the generator ``traffic/<kind>.py``); the limits of its
output check are ``workloads/<cell>.json``; each metric is read by
``metrics/<metric>.py``; each configuration's plain reference is
``reference/<reference>.py``.  Nothing here imports JAX or the JAX package.
"""
