"""RATDB (JSON dump) parser (the port's copy of
chroma_tpu/rat/ratdb_parser.py; parity: chroma/rat/ratdb_parser.py).

RATDB entries are validity "planes": default (valid 0/0), user (-1/-1)
and run-specific; later planes override earlier ones per (name, index).
"""
import json
from copy import deepcopy
from pathlib import Path

from chroma_tpu_torch.log import logger


class RatDBParser:
    def __init__(self, ratdb_path, run_number=None, merge=True):
        self.ratdb_path = Path(ratdb_path)
        self.run_number = run_number
        with open(self.ratdb_path, 'r') as f:
            self.entries = json.load(f)
        self.db = None
        if merge:
            self.merge_all_planes()
            self.db = self.create_db()
        else:
            logger.warning('Database is not merged; entry uniqueness is '
                           'not guaranteed.')

    def get_entries_for_plane(self, plane_name, run_number=None):
        if plane_name == 'default':
            cond = lambda e: e['valid_begin'] == 0 and e['valid_end'] == 0
        elif plane_name == 'user':
            cond = lambda e: e['valid_begin'] == -1 and e['valid_end'] == -1
        elif plane_name == 'run':
            if run_number is None:
                cond = lambda e: e['valid_begin'] > 0 or e['valid_end'] > 0
            else:
                cond = lambda e: (e['valid_begin'] <= run_number
                                  or e['valid_end'] >= run_number)
        else:
            raise ValueError('Invalid plane name: %s' % plane_name)
        return [dict(e) for e in self.entries if cond(e)]

    @staticmethod
    def _merge_entry(base_entry, new_entry, override_base=False):
        assert base_entry['name'] == new_entry['name']
        assert base_entry['index'] == new_entry['index']
        result = base_entry if override_base else deepcopy(base_entry)
        result.update(new_entry)
        return result

    @staticmethod
    def _merge_planes(base_plane, new_plane):
        merged = deepcopy(base_plane)
        by_key = {(e.get('name'), e.get('index')): e for e in merged}
        for new_entry in new_plane:
            key = (new_entry.get('name'), new_entry.get('index'))
            if key in by_key:
                RatDBParser._merge_entry(by_key[key], new_entry,
                                         override_base=True)
            else:
                merged.append(new_entry)
                by_key[key] = new_entry
        return merged

    def merge_all_planes(self):
        default = self.get_entries_for_plane('default')
        run = self.get_entries_for_plane('run', run_number=self.run_number)
        user = self.get_entries_for_plane('user')
        merged = self._merge_planes(default, run)
        self.entries = self._merge_planes(merged, user)

    def create_db(self):
        db = {}
        for entry in self.entries:
            table = db.setdefault(entry.get('name'), {})
            index = entry.get('index')
            if index in table:
                raise ValueError('Duplicate entry for %s index %s'
                                 % (entry.get('name'), index))
            table[index] = entry
        return db

    def get_entry(self, table_name, index):
        if self.db is None:
            for entry in self.entries:
                if entry.get('name') == table_name \
                        and entry.get('index') == index:
                    return entry
            return None
        return self.db.get(table_name, {}).get(index, None)

    def get_table(self, table_name, as_list=False):
        if self.db is None:
            matches = [e for e in self.entries
                       if e.get('name') == table_name]
            return matches if as_list \
                else {e.get('index'): e for e in matches}
        result = self.db.get(table_name, None)
        if as_list:
            return list(result.values()) if result is not None else []
        return result
