"""Core types, partitioning, frontier ops and validation."""
