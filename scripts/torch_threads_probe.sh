#!/bin/bash
# Wall time of COPIES concurrent pytest runs of one selection of the
# port's CPU tests, with torch's intra-op threads set to THREADS in each
# (0 = torch's default, one per core). It shows what the tier-1 run's
# xdist workers cost each other: tests/torch_cpu.py pins one thread.
#
#   scripts/torch_threads_probe.sh THREADS [COPIES] [PYTEST SELECTION...]
#
# e.g. scripts/torch_threads_probe.sh 2 6 tests/test_torch_grammar.py \
#          -k "streams_equal_the_jax_engine and paged"
# Prints one line per copy (its exit code and ms) and the wall time.
set -u
threads=${1:?threads}
copies=${2:-6}
shift $(( $# >= 2 ? 2 : 1 ))
[ $# -gt 0 ] || set -- tests/test_torch_grammar.py -k "streams_equal_the_jax_engine and paged"
cd "$(dirname "$0")/.."
plugin=$(mktemp -d)
trap 'rm -rf "$plugin"' EXIT
# set after collection: every test module (tests/torch_cpu.py among them)
# has been imported by then
cat > "$plugin/probe_threads.py" <<EOF
import sys

import torch

DEFAULT = torch.get_num_threads()       # before any test module caps it


def pytest_collection_finish(session):
    torch.set_num_threads($threads or DEFAULT)
    sys.__stdout__.write(f"torch intra-op threads: {torch.get_num_threads()}\\n")
EOF
start=$(date +%s%N)
for i in $(seq "$copies"); do
  (
    t0=$(date +%s%N)
    PYTHONPATH="$plugin${PYTHONPATH:+:$PYTHONPATH}" JAX_PLATFORMS=cpu \
      python -m pytest -q -p probe_threads -p no:cacheprovider "$@" > "$plugin/copy$i.log" 2>&1
    rc=$?
    echo "copy $i: rc=$rc $(( ($(date +%s%N) - t0) / 1000000 )) ms ($(grep -m1 'intra-op' "$plugin/copy$i.log"))"
  ) &
done
wait
echo "threads=$threads copies=$copies wall $(( ($(date +%s%N) - start) / 1000000 )) ms"
