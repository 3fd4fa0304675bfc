"""A minimal HTML gallery page (counterpart of
``desr_tpu/utils/html.py``): ``add_header`` / ``add_images`` / ``save``,
with plain string templating and the same HTML text.
"""

from __future__ import annotations

import os


class HTML:
    def __init__(self, web_dir, title, refresh=0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self._body = []

    def get_image_dir(self):
        return self.img_dir

    def add_header(self, text):
        self._body.append(f"<h3>{text}</h3>")

    def add_images(self, ims, txts, links, width=400):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                f'<td style="word-wrap: break-word;" halign="center" valign="top">'
                f'<p><a href="images/{link}"><img style="width:{width}px" '
                f'src="images/{im}"></a><br><p>{txt}</p></p></td>')
        self._body.append(
            '<table border="1" style="table-layout: fixed;"><tr>' + "".join(cells) + "</tr></table>")

    def save(self):
        refresh = (f'<meta http-equiv="refresh" content="{self.refresh}">'
                   if self.refresh > 0 else "")
        html = (f"<!DOCTYPE html><html><head><title>{self.title}</title>{refresh}</head>"
                f"<body>{''.join(self._body)}</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "wt") as f:
            f.write(html)
