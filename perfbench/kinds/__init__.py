"""One module per kind of traffic; a traffic file's ``kind`` names it."""
