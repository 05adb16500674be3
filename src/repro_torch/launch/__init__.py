"""Reporting helpers of the port (counterpart of ``repro.launch``)."""
