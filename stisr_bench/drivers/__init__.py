"""The mixes' drivers, one module a driver, loaded by path."""
