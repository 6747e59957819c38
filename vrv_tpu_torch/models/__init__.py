"""Flagship end-to-end renderer configurations."""
