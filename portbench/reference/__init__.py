"""Plain references that decide ``correct``; each imports nothing of the
program."""
