"""The analytic test-case generator (closed forms against simulations)."""
