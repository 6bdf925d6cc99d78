"""World builders of the port: the demo terrain and the streaming
RenderGrid3 builder."""
