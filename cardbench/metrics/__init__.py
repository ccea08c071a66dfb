"""One module a metric, named as in BENCHMARK.json: `read(run)` returns
the metric's number from a finished run (cardbench.run.Run), or None
where it finds nothing to read, and the harness then leaves it out."""
