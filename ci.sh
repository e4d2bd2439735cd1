#!/usr/bin/env bash
# CI pipeline (SURVEY.md §2.1 CI row — the reference used Travis/AppVeyor;
# this is the local/offline equivalent, runnable on any checkout).
set -euo pipefail
cd "$(dirname "$0")"

echo "== build oracle =="
make oracle

echo "== unit + interop tests (CPU, 8 virtual devices) =="
python -m pytest tests/ -q -n 4

echo "== sanitizer pass =="
make test-asan

echo "== CLI selftest =="
python -m tpz selftest

echo "CI OK"
