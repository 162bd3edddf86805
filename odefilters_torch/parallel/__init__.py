"""Time-parallel fixed-grid solves (counterpart of ``odefilters/parallel``):
iterated square-root associative scans, global or windowed."""
