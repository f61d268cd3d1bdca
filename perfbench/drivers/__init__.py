"""Drivers: one module per kind of run (``traffic/<traffic>.json`` names
one), each defining ``Driver``."""
