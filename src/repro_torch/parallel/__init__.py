"""The port's mesh layer: logical-axis sharding rules on DTensor."""
