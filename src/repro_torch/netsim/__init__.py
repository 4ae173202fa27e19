"""Fluid fabric model: topology data, flows, fault timelines and the
slot engine."""
