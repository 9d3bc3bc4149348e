"""Command-line entry points (serve, train, dryrun) and the multi-rank
launch modules (mesh, actctx, sharding, steps)."""
