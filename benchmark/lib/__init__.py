"""The benchmark's own machinery: manifest, spans, trace reduction,
rooflines, statistics and the run loop."""
