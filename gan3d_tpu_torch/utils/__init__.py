"""Utilities: device selection and PNG volume grids."""
