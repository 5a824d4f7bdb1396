PY ?= python
export PYTHONPATH := src:$(PYTHONPATH)

.PHONY: test test-fast lint bench-smoke bench-api bench examples serve docs-check

test:
	$(PY) -m pytest -x -q

# invariant analyzer suite (repro.analysis): lock discipline, policy
# purity, determinism, wire-registry cross-checks, deadline coverage.
# Fails on any finding not covered by src/repro/analysis/baseline.json;
# the port's copy (repro_torch.analysis) checks src/repro_torch against
# src/repro_torch/analysis/baseline.json.
lint:
	$(PY) -m repro.analysis
	$(PY) -m repro_torch.analysis

test-fast:
	$(PY) -m pytest -x -q tests/test_api_gateway.py tests/test_platform.py \
		tests/test_http_api.py tests/test_federation.py \
		tests/test_ratelimit.py tests/test_kvstore.py \
		tests/test_scheduler.py

# local platform + HTTP API on :8084; prints one API key per tenant
serve:
	$(PY) -m repro.api.cli serve --port 8084 --tenant demo --tenant staging

# the docs are a contract: CLI must parse, docs/api.md must match the code
docs-check:
	$(PY) -m repro.api.cli --help > /dev/null
	$(PY) -m pytest -q tests/test_docs_api.py

bench-smoke:
	PYTHONPATH=src:. $(PY) benchmarks/api_tier.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/hotpath.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/observability.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/operator.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/serving.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/faults.py --quick
	PYTHONPATH=src:. $(PY) benchmarks/recovery.py

# the full API-tier drill, including the timing-sensitive p99 assertions
# (rate-limit isolation, 4-shard vs single-lock federation read tail)
bench-api:
	PYTHONPATH=src:. $(PY) benchmarks/api_tier.py

bench:
	PYTHONPATH=src:. $(PY) benchmarks/run.py

examples:
	$(PY) examples/quickstart.py
	$(PY) examples/multi_tenant.py
