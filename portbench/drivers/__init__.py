"""One module a kind of run; a traffic file names its driver, and each
driver's ``run(ctx)`` returns a ``harness.Outcome``."""
