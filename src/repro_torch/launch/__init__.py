"""Launchers (port of `repro.launch`): `serve`, `train`."""
