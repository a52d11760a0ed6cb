"""The yardstick: read generation, the plain reference codec, byte counts,
spans, the device trace's reduction, and the run's context."""
