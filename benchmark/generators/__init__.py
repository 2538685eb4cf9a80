"""Traffic kinds: each module's ``run(ctx)`` warms its own path, measures
the window and returns its record (see ``harness.run_cell``)."""
