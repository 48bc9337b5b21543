"""The harness's tests run on the CPU (python -m pytest port_bench/tests);
those marked cuda need a card and skip without one."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA card (skips without one)')
