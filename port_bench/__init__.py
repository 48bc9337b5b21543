"""The benchmark of the PyTorch/H100 port (learning_to_adapt_torch).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Everything a cell needs is found by name: its configuration under
configs/, its traffic under workloads/, the module of the traffic's kind
under drivers/, each per-layer metric's reader under metrics/. The
yardstick (reference/, roofline/, lib/) is kept here, apart from the
program, so that a change to the program cannot change it.
"""
