"""Stream-parallel execution: many VO streams in one set of launches."""
