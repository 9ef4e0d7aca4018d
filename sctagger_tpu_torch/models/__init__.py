"""Models of the port (nothing imported eagerly)."""
