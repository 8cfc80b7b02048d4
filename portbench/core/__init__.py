"""The general part of the harness: it knows no configuration, traffic mix,
entry point or metric by name, and finds each by the names in
BENCHMARK.json (core/spec.py)."""
