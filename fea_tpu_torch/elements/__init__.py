"""Element formulations."""
