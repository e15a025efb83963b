"""The harness: spec, data, trace, spans, peaks and stats."""
