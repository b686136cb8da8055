"""Drivers of the traffic mixes: a mix's ``driver`` key names one of these
modules, and its other keys are the driver's parameters."""
