"""Timestamped-file artifact store — the pipeline's checkpoint/resume layer.

A copy of ``mba_tpu/utils/file_management.py`` (stdlib only), since the
port never imports ``mba_tpu``.

Parity target: reference ``src/utils/file_management.py`` — every pipeline
stage writes ``YYYY-MM-DD HH_MM_SS <Title>.<suffix>`` artifacts and every
consumer resolves "the most recent file matching keywords"
(file_management.py:9-125); ``TxtConfig`` parses ``PROP --- VALUE`` files
(file_management.py:132-192); ``fetch_json_recursively`` walks subject
directories for questionnaire/summary JSONs (file_management.py:195-235).
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from pathlib import Path
from typing import Literal, Union


def file_title(title: str, dtype_suffix: str = ".svg",
               short: bool = False) -> str:
    """Timestamped file title: ``YYYY-MM-DD HH_MM_SS <title><suffix>``."""
    if short:
        return datetime.now().strftime('%Y%m%d') + " " + title + dtype_suffix
    return (datetime.now().strftime('%Y-%m-%d %H_%M_%S')
            + " " + title + dtype_suffix)


def most_recent_file(directory: Path | str,
                     suffix_to_consider: str | None = None,
                     file_title_keywords: list[str] | str | None = None,
                     search_by: Literal["file-title", "meta-data"] = "file-title",
                     return_type: Literal["dict", "latest_file_path"] = "latest_file_path",
                     ) -> Path | dict:
    """Find the most recent file(s) by filename timestamp or mtime.

    ``search_by='file-title'`` parses the leading ``YYYY-MM-DD HH_MM_SS``
    prefix; files without a valid prefix are skipped.
    """
    if search_by not in ("file-title", "meta-data"):
        raise ValueError(
            f"search_by must be 'file-title' or 'meta-data', got {search_by}")
    directory = Path(directory)
    if not directory.is_dir():
        raise ValueError(f"Provided path {directory} is not a directory!")
    if isinstance(file_title_keywords, str):
        file_title_keywords = [file_title_keywords]

    file_list, date_list = [], []
    for entry in os.scandir(directory):
        if not entry.is_file():
            continue
        filename = entry.name
        if suffix_to_consider is not None:
            if not filename.endswith(suffix_to_consider):
                continue
        elif '.DS_Store' in filename:
            continue
        if file_title_keywords is not None:
            if not all(kw in filename for kw in file_title_keywords):
                continue
        if search_by == "file-title":
            try:
                date = datetime.fromisoformat(
                    filename[:10] + ' ' + filename[11:19].replace('_', ':'))
            except (ValueError, IndexError):
                continue
        else:
            date = entry.stat().st_mtime
        file_list.append(directory / filename)
        date_list.append(date)

    if not file_list:
        raise ValueError(
            "Provided directory doesn't contain files matching the provided "
            "criteria!")

    order = sorted(range(len(date_list)), key=lambda i: date_list[i],
                   reverse=True)
    sorted_files = [file_list[i] for i in order]
    sorted_dates = [date_list[i] for i in order]
    if return_type == "latest_file_path":
        return sorted_files[0]
    return {"files": sorted_files, "dates": sorted_dates}


def assert_dir(dir_path: str | Path) -> None:
    """Create directory (and parents) if missing."""
    Path(dir_path).mkdir(parents=True, exist_ok=True)


class TxtConfig:
    """``PROPERTY_NAME --- ENTRY`` text-config file with typed getters."""

    def __init__(self, txt_file_path: Union[Path, str],
                 read_only_mode: bool = True):
        self.txt_file_path = txt_file_path
        self.read_only_mode = read_only_mode

    @property
    def settings_dict(self) -> dict:
        temp = {}
        with open(self.txt_file_path, "r") as file:
            for line in file:
                if line.startswith("#") or line == "\n":
                    continue
                entry = line.split(' --- ')
                if len(entry) != 2:
                    raise ValueError(
                        "Provided file may only contain lines structured as "
                        "'PROPERTY_NAME --- ENTRY'!\n"
                        f"Found line: >> {line} <<")
                temp[entry[0].strip()] = entry[1].strip()
        return temp

    def change_entry(self, entry, new_entry) -> None:
        if self.read_only_mode:
            raise ValueError(
                "TxtConfig is in read-only mode, hence cannot modify entry!")
        temp = self.settings_dict
        temp[entry] = new_entry
        self._set_dict_to_file(temp)

    def _set_dict_to_file(self, new_dict: dict) -> None:
        if self.read_only_mode:
            raise ValueError(
                "TxtConfig is in read-only mode, hence cannot modify entry!")
        with open(self.txt_file_path, "w") as file:
            file.write("# This file was changed during runtime.\n"
                       "# The structure is 'PROPERTY_NAME --- ENTRY'. "
                       "Lines starting with '#' are ignored.\n")
            for key, value in new_dict.items():
                if isinstance(value, list):
                    value = ", ".join(str(e) for e in value)
                file.write(f"{key} --- {value}\n")

    def get_as_type(self, key,
                    value_type: Literal["int", "float", "float_list",
                                        "str_list", "list", "bool", "str"]):
        value = self.settings_dict[key]
        if value_type == "int":
            return int(value)
        if value_type == "float":
            return float(value)
        if value_type == "bool":
            return value == 'True' or value == '1'
        if value_type == "str":
            return str(value)
        if value_type in ("float_list", "str_list", "list"):
            entries = value.split(', ')
            if len(entries) <= 1:
                raise ValueError(
                    "List entries need to be formatted as "
                    "'ENTRY_1, ENTRY_2, ENTRY_3, ...'!")
            return ([float(e) for e in entries]
                    if value_type == "float_list" else entries)
        raise ValueError(f"Provided value type '{value_type}' is not "
                         "recognized!")


def fetch_json_recursively(dir: str | Path, file_identifier: str,
                           value_key: str,
                           with_time_from_file_title: bool = False
                           ) -> list | dict:
    """Collect ``value_key`` from every matching JSON under ``dir``."""
    dir = Path(dir)
    values: dict | list = {} if with_time_from_file_title else []
    for item in sorted(dir.iterdir()):
        if item.is_dir():
            sub = fetch_json_recursively(item, file_identifier, value_key,
                                         with_time_from_file_title)
            if with_time_from_file_title:
                values.update(sub)
            else:
                values.extend(sub)
        elif item.is_file():
            if file_identifier in item.stem and item.suffix == '.json':
                try:
                    with open(item, "r", encoding="utf-8") as f:
                        value = json.load(f)[value_key]
                    if with_time_from_file_title:
                        parts = item.stem.split(" ")
                        values[f"{parts[0]} {parts[1]}"] = value
                    else:
                        values.append(value)
                except (json.JSONDecodeError, KeyError, IndexError,
                        FileNotFoundError) as e:
                    print(f"Warning: Could not read value from {item}: {e}")
    return values
