"""Command-line tools: installer, dedicated server, terminal client, web viewer."""
