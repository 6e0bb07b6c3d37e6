"""Serving runtime: the GraphServe sync core and its clock."""
