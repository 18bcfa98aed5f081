"""Serving entry points of the LM zoo, for the port (``repro/launch``)."""
