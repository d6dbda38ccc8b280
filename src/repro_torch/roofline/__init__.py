"""Storage-tier constants of the simulated clock."""
