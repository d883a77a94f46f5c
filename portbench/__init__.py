"""The benchmark of the PyTorch and CUDA port, ``nbody_streams_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that names a configuration, a traffic mix or a metric lives in
files found by the names in ``BENCHMARK.json`` (see ``README.md``).
"""
