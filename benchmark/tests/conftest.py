"""The benchmark's own tests (``python -m pytest benchmark/tests``). The
harness's modules are imported as the harness imports them: the benchmark
folder first on the path, the checkout's root after it."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))
