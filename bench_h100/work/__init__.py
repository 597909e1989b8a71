"""The operations and bytes a step's work needs, counted from shapes and
from the step's own inputs, never from how a kernel does it: each input
byte read once, each output byte written once."""
