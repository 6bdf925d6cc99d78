"""World-format constants of the port."""
