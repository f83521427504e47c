"""Visualisation: PNG / GIF rendering (matplotlib, imported when used), the
self-contained HTML viewer and the live HTTP/SSE viewer."""
