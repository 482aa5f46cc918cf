"""Host-side utilities: checkpoint / resume (``checkpoint``)."""
