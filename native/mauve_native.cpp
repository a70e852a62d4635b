// mauve_native: native host runtime for mauvealigner_tpu.
//
// The accelerator does the compute-heavy phases (sorts, DP, HMM scans); this module
// covers the host-side hot paths the reference implements in C++ via
// libGenome/libMems: FASTA parsing, 2-bit encoding, reverse complement, and
// base-level maximal match extension (MemHash extension inner loop).
// Python binds via the CPython C API (no pybind11 in the image).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

unsigned char kEncode[256];
unsigned char kComp[256];

void init_tables() {
  memset(kEncode, 4, sizeof(kEncode));
  kEncode[(int)'A'] = 0; kEncode[(int)'a'] = 0;
  kEncode[(int)'C'] = 1; kEncode[(int)'c'] = 1;
  kEncode[(int)'G'] = 2; kEncode[(int)'g'] = 2;
  kEncode[(int)'T'] = 3; kEncode[(int)'t'] = 3;
  for (int i = 0; i < 256; i++) kComp[i] = (unsigned char)i;
  auto set = [](char a, char b) {
    kComp[(int)a] = (unsigned char)b;
    kComp[(int)(a + 32)] = (unsigned char)(b + 32);
  };
  set('A', 'T'); set('C', 'G'); set('G', 'C'); set('T', 'A'); set('U', 'A');
  set('R', 'Y'); set('Y', 'R'); set('K', 'M'); set('M', 'K');
  set('B', 'V'); set('V', 'B'); set('D', 'H'); set('H', 'D');
}

// parse_fasta(data: bytes) -> (seq: bytes, contigs: list[(name, length)])
PyObject* parse_fasta(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const char* p = (const char*)buf.buf;
  Py_ssize_t n = buf.len;

  std::string seq;
  seq.reserve((size_t)n);
  PyObject* contigs = PyList_New(0);
  std::string name;
  size_t contig_start = 0;
  bool have_contig = false;

  auto flush = [&]() -> bool {
    if (!have_contig) return true;
    PyObject* tup = Py_BuildValue(
        "(s#n)", name.data(), (Py_ssize_t)name.size(),
        (Py_ssize_t)(seq.size() - contig_start));
    if (!tup) return false;
    int rc = PyList_Append(contigs, tup);
    Py_DECREF(tup);
    return rc == 0;
  };

  Py_ssize_t i = 0;
  while (i < n) {
    if (p[i] == '>') {
      if (!flush()) { Py_DECREF(contigs); PyBuffer_Release(&buf); return nullptr; }
      Py_ssize_t j = i + 1;
      while (j < n && p[j] != '\n' && p[j] != '\r') j++;
      name.assign(p + i + 1, (size_t)(j - i - 1));
      while (!name.empty() && (name.back() == ' ' || name.back() == '\t')) name.pop_back();
      size_t lead = 0;
      while (lead < name.size() && (name[lead] == ' ' || name[lead] == '\t')) lead++;
      name.erase(0, lead);
      contig_start = seq.size();
      have_contig = true;
      i = j;
    } else {
      Py_ssize_t j = i;
      while (j < n && p[j] != '\n' && p[j] != '\r' && p[j] != '>') {
        char c = p[j];
        if (c > ' ') seq.push_back(c);
        j++;
      }
      if (j < n && p[j] == '>') { i = j; continue; }
      i = j + 1;
      continue;
    }
    i++;
  }
  if (!flush()) { Py_DECREF(contigs); PyBuffer_Release(&buf); return nullptr; }
  PyBuffer_Release(&buf);
  PyObject* seq_bytes = PyBytes_FromStringAndSize(seq.data(), (Py_ssize_t)seq.size());
  if (!seq_bytes) { Py_DECREF(contigs); return nullptr; }
  PyObject* out = Py_BuildValue("(NN)", seq_bytes, contigs);
  return out;
}

// encode(data: bytes) -> bytes of 2-bit codes (4 = ambiguity)
PyObject* encode(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, buf.len);
  if (!out) { PyBuffer_Release(&buf); return nullptr; }
  unsigned char* dst = (unsigned char*)PyBytes_AS_STRING(out);
  const unsigned char* src = (const unsigned char*)buf.buf;
  for (Py_ssize_t i = 0; i < buf.len; i++) dst[i] = kEncode[src[i]];
  PyBuffer_Release(&buf);
  return out;
}

// revcomp(data: bytes) -> bytes (IUPAC-aware ASCII reverse complement)
PyObject* revcomp(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, buf.len);
  if (!out) { PyBuffer_Release(&buf); return nullptr; }
  unsigned char* dst = (unsigned char*)PyBytes_AS_STRING(out);
  const unsigned char* src = (const unsigned char*)buf.buf;
  for (Py_ssize_t i = 0; i < buf.len; i++) dst[i] = kComp[src[buf.len - 1 - i]];
  PyBuffer_Release(&buf);
  return out;
}

// extend_matches(codes: list[bytes], starts: bytes (int64 LE, row-major
// [n, n_seqs]), lengths: bytes (int64 LE, [n])) -> (starts', lengths')
// Base-level maximal extension of every match in both directions.
PyObject* extend_matches(PyObject*, PyObject* args) {
  PyObject* codes_list;
  Py_buffer sbuf, lbuf;
  Py_ssize_t n, n_seqs;
  if (!PyArg_ParseTuple(args, "Oy*y*nn", &codes_list, &sbuf, &lbuf, &n, &n_seqs))
    return nullptr;
  std::vector<const unsigned char*> codes;
  std::vector<int64_t> seq_lens;
  Py_ssize_t n_genomes = PyList_Size(codes_list);
  for (Py_ssize_t g = 0; g < n_genomes; g++) {
    PyObject* b = PyList_GetItem(codes_list, g);
    codes.push_back((const unsigned char*)PyBytes_AS_STRING(b));
    seq_lens.push_back((int64_t)PyBytes_GET_SIZE(b));
  }
  std::vector<int64_t> starts((int64_t*)sbuf.buf, (int64_t*)sbuf.buf + n * n_seqs);
  std::vector<int64_t> lengths((int64_t*)lbuf.buf, (int64_t*)lbuf.buf + n);
  PyBuffer_Release(&sbuf);
  PyBuffer_Release(&lbuf);

  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t m = 0; m < n; m++) {
    int64_t* row = &starts[m * n_seqs];
    // match-space column c of component j (0-based left0 = |start|-1):
    //   fwd: left0 + c ; rev: left0 + len - 1 - c (complemented)
    for (int dir = 1; dir >= -1; dir -= 2) {
      for (;;) {
        int base = -1;
        bool ok = true;
        for (Py_ssize_t j = 0; j < n_seqs && ok; j++) {
          int64_t s = row[j];
          if (s == 0) continue;
          bool fwd = s > 0;
          int64_t left0 = (s > 0 ? s : -s) - 1;
          int64_t idx;
          bool genome_right = (dir > 0) == fwd;
          if (genome_right) idx = left0 + lengths[m];
          else idx = left0 - 1;
          if (idx < 0 || idx >= seq_lens[j]) { ok = false; break; }
          int c = codes[j][idx];
          if (c >= 4) { ok = false; break; }
          if (!fwd) c = 3 - c;
          if (base < 0) base = c;
          else if (base != c) ok = false;
        }
        if (!ok || base < 0) break;
        for (Py_ssize_t j = 0; j < n_seqs; j++) {
          int64_t s = row[j];
          if (s == 0) continue;
          bool fwd = s > 0;
          bool genome_right = (dir > 0) == fwd;
          if (!genome_right) row[j] = fwd ? s - 1 : s + 1;
        }
        lengths[m]++;
      }
    }
  }
  Py_END_ALLOW_THREADS

  PyObject* s_out = PyBytes_FromStringAndSize(
      (const char*)starts.data(), (Py_ssize_t)(starts.size() * sizeof(int64_t)));
  PyObject* l_out = PyBytes_FromStringAndSize(
      (const char*)lengths.data(), (Py_ssize_t)(lengths.size() * sizeof(int64_t)));
  if (!s_out || !l_out) { Py_XDECREF(s_out); Py_XDECREF(l_out); return nullptr; }
  return Py_BuildValue("(NN)", s_out, l_out);
}

// eliminate_overlaps(starts: bytes (int64 LE [n, n_seqs]), lengths: bytes
// (int64 LE [n]), n, n_seqs) -> (starts', lengths')
// Pairwise overlap resolution within each sequence (EliminateOverlaps_v2
// semantics); bit-identical to the Python reference loop in
// core/match.py::eliminate_overlaps.  Rows cropped to length <= 0 remain in
// the output (the caller filters them).
PyObject* eliminate_overlaps(PyObject*, PyObject* args) {
  Py_buffer sbuf, lbuf;
  Py_ssize_t n, n_seqs;
  if (!PyArg_ParseTuple(args, "y*y*nn", &sbuf, &lbuf, &n, &n_seqs))
    return nullptr;
  std::vector<int64_t> starts((int64_t*)sbuf.buf, (int64_t*)sbuf.buf + n * n_seqs);
  std::vector<int64_t> lengths((int64_t*)lbuf.buf, (int64_t*)lbuf.buf + n);
  PyBuffer_Release(&sbuf);
  PyBuffer_Release(&lbuf);

  Py_BEGIN_ALLOW_THREADS
  // multiplicity is invariant under cropping (components never vanish)
  std::vector<int64_t> mult(n, 0);
  for (Py_ssize_t i = 0; i < n; i++)
    for (Py_ssize_t j = 0; j < n_seqs; j++)
      if (starts[i * n_seqs + j] != 0) mult[i]++;

  std::vector<char> removed(n, 0);
  std::vector<Py_ssize_t> order;
  order.reserve(n);
  auto llabs64 = [](int64_t v) { return v < 0 ? -v : v; };

  bool changed = true;
  int iters = 0;
  while (changed && iters < 8) {
    changed = false;
    iters++;
    for (Py_ssize_t seq = 0; seq < n_seqs; seq++) {
      order.clear();
      for (Py_ssize_t i = 0; i < n; i++)
        if (!removed[i] && starts[i * n_seqs + seq] != 0) order.push_back(i);
      if (order.size() < 2) continue;
      std::stable_sort(order.begin(), order.end(),
                       [&](Py_ssize_t a, Py_ssize_t b) {
                         return llabs64(starts[a * n_seqs + seq]) <
                                llabs64(starts[b * n_seqs + seq]);
                       });
      Py_ssize_t prev = order[0];
      for (size_t oi = 1; oi < order.size(); oi++) {
        Py_ssize_t cur = order[oi];
        int64_t prev_r = llabs64(starts[prev * n_seqs + seq]) + lengths[prev] - 1;
        int64_t cur_l = llabs64(starts[cur * n_seqs + seq]);
        if (cur_l <= prev_r && lengths[cur] > 0 && lengths[prev] > 0) {
          int64_t overlap = prev_r - cur_l + 1;
          // crop the weaker match: lower multiplicity, then shorter
          bool prev_weaker =
              mult[prev] < mult[cur] ||
              (mult[prev] == mult[cur] && lengths[prev] < lengths[cur]);
          bool victim_is_cur = !prev_weaker;
          Py_ssize_t victim = victim_is_cur ? cur : prev;
          int64_t amt = overlap < lengths[victim] ? overlap : lengths[victim];
          bool overlap_on_genome_left = victim_is_cur;
          bool forward = starts[victim * n_seqs + seq] > 0;
          if (overlap_on_genome_left == forward) {
            // match-space left crop: forward components advance
            for (Py_ssize_t j = 0; j < n_seqs; j++)
              if (starts[victim * n_seqs + j] > 0) starts[victim * n_seqs + j] += amt;
          } else {
            for (Py_ssize_t j = 0; j < n_seqs; j++)
              if (starts[victim * n_seqs + j] < 0) starts[victim * n_seqs + j] -= amt;
          }
          lengths[victim] -= amt;
          changed = true;
        }
        int64_t cur_r = llabs64(starts[cur * n_seqs + seq]) + lengths[cur] - 1;
        prev_r = llabs64(starts[prev * n_seqs + seq]) + lengths[prev] - 1;
        if (cur_r > prev_r || lengths[prev] <= 0) prev = cur;
      }
    }
    for (Py_ssize_t i = 0; i < n; i++)
      if (lengths[i] <= 0) removed[i] = 1;
  }
  Py_END_ALLOW_THREADS

  PyObject* s_out = PyBytes_FromStringAndSize(
      (const char*)starts.data(), (Py_ssize_t)(starts.size() * sizeof(int64_t)));
  PyObject* l_out = PyBytes_FromStringAndSize(
      (const char*)lengths.data(), (Py_ssize_t)(lengths.size() * sizeof(int64_t)));
  if (!s_out || !l_out) { Py_XDECREF(s_out); Py_XDECREF(l_out); return nullptr; }
  return Py_BuildValue("(NN)", s_out, l_out);
}

PyMethodDef kMethods[] = {
    {"parse_fasta", parse_fasta, METH_VARARGS,
     "parse_fasta(data) -> (seq_bytes, [(name, length), ...])"},
    {"encode", encode, METH_VARARGS, "ASCII -> 2-bit codes (4 = ambiguity)"},
    {"revcomp", revcomp, METH_VARARGS, "IUPAC ASCII reverse complement"},
    {"extend_matches", extend_matches, METH_VARARGS,
     "maximal base-level extension of a match table"},
    {"eliminate_overlaps", eliminate_overlaps, METH_VARARGS,
     "pairwise overlap resolution within each sequence"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "mauve_native",
    "native host runtime for mauvealigner_tpu", -1, kMethods,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit_mauve_native(void) {
  init_tables();
  return PyModule_Create(&kModule);
}
