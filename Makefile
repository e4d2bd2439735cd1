# Top-level build/test entry points (SURVEY.md §2.1 CI row).

.PHONY: all oracle test test-fast test-gpu test-asan bench clean selftest

all: oracle

# Builds (or finds) cpp/build/<host+sources key>/libtpz_oracle.so — the
# same build every library user triggers at first use.
oracle:
	python -c "from tpz import oracle; print(oracle.build())"

test: oracle
	python -m pytest tests/ -q -n 4

# Skips the whole-codec device-pipeline modules (marked slow in
# tests/conftest.py) — a short local loop; CI (ci.sh) runs everything.
test-fast: oracle
	python -m pytest tests/ -q -n 4 -m "not slow"

# On a GPU machine: the suite on the GPU platform, including the tests
# marked `gpu` (compiled Triton kernels against their references).
test-gpu: oracle
	TPZ_TEST_GPU=1 python -m pytest tests/ -q -m "gpu or not slow"

# Sanitizer pass over the C++ oracle (SURVEY.md §5 race-detection row):
# rebuilds with ASan+UBSan and exercises every codec through the bindings.
test-asan:
	$(MAKE) -C cpp asan
	TPZ_ORACLE_LIB=cpp/libtpz_oracle_asan.so \
	LD_PRELOAD=$$(g++ -print-file-name=libasan.so) \
	ASAN_OPTIONS=detect_leaks=0 \
	python -m pytest tests/test_oracle_deflate.py tests/test_bzip2.py \
	    tests/test_oracle_scans.py \
	    tests/test_lzhuf.py -q

bench: oracle
	python bench.py

selftest: oracle
	python -m tpz selftest

clean:
	$(MAKE) -C cpp clean
