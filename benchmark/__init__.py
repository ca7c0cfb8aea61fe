"""The benchmark of particle_sim_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON result line.
The cells, configurations, traffic mixes and metrics are files of their
own under this directory, found by the names in ``BENCHMARK.json``
(README.md).
"""
