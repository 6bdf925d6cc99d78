"""World builders of the port: the demo terrain."""
