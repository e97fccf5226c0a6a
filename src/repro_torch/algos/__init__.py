"""Frontier programs and their driver."""
