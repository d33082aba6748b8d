"""The harness: traffic, the run loop, the trace reader, the work model."""
