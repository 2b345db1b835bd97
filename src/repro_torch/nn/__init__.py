"""Declarative module graphs and their parameter specs."""
