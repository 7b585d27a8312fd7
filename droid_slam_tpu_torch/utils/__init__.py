"""Map visualisation and export of the port."""
