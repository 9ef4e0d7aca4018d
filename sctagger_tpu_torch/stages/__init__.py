"""Stage entry points of the port (nothing imported eagerly)."""
