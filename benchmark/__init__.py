"""The port's benchmark: harness, cells, plain reference and yardstick.

Run one cell with ``python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the repository root
names the cells, their configurations, traffic mixes and metrics, and the
harness finds each one's file under this folder by that name.
"""
