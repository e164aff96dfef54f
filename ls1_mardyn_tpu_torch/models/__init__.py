"""Physical model layer: components, pair parameters, LJ-12-6."""
