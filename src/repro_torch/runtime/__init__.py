"""The LM training runtime (port of `repro.runtime`): `steps`, `fault`, `trainer`."""
