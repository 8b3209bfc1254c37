"""Readers and writers (numpy): parameters, tables, surfaces, PDG lists."""
