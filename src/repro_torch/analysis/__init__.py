"""Measurement for the port: the device database and analytic workload
model (`mfu`), and kernel launches counted on the card (`launches`)."""
