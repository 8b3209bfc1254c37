"""Per-cell physics in torch f64: splines, rest-frame algebra, delta-f."""
