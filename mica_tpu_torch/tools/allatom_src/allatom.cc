// mica-allatom: rebuild a full-atom protein model from a CA-only trace.
//
// Native (C++) counterpart of the role PULCHRA plays in the reference
// pipeline (modules/pulchra304, invoked as `pulchra <frag>.pdb -c`,
// modeler.py:294-419).  This is an independent implementation, not a port:
//
//   * backbone N/C/O placement from ideal trans-peptide geometry oriented
//     per-residue by the local CA curvature, with a per-peptide rotation
//     search that maximizes hydrogen-bond-like geometry and minimizes
//     clashes (replaces PULCHRA's binned statistical fragment library);
//   * side chains (incl. CB) placed from a behaviorally-calibrated
//     conformation table keyed by the local CA-geometry bins
//     (sidechain_table.h, built by calibrate_sidechains.py driving the
//     shipped reference binary as a black-box oracle — its own rotamer
//     coordinate table is not even present in the reference snapshot);
//     fragment terminals and unknown types fall back to NeRF growth from
//     an internal-coordinate table with clash-scored chi-well candidates,
//     with CB from ideal L-amino-acid tetrahedral geometry;
//   * excluded-volume relaxation on a spatial hash grid;
//   * chain splitting at chain-ID changes and residue-number gaps,
//     matching the fragment semantics of the reference driver.
//
// Usage: mica_allatom <ca_model.pdb> <out.pdb>
//
// Exit 0 on success.

#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
};

double dot(const Vec3 &a, const Vec3 &b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
Vec3 cross(const Vec3 &a, const Vec3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
double norm(const Vec3 &a) { return std::sqrt(dot(a, a)); }
Vec3 unit(const Vec3 &a) {
  double n = norm(a);
  return n > 1e-9 ? a * (1.0 / n) : Vec3(1, 0, 0);
}
double dist(const Vec3 &a, const Vec3 &b) { return norm(a - b); }

// NeRF: place D given A-B-C, bond |CD|, angle B-C-D (deg), dihedral A-B-C-D.
Vec3 nerf(const Vec3 &a, const Vec3 &b, const Vec3 &c, double bond,
          double angle_deg, double dihedral_deg) {
  const double ang = angle_deg * M_PI / 180.0;
  const double dih = dihedral_deg * M_PI / 180.0;
  Vec3 bc = unit(c - b);
  Vec3 n = unit(cross(b - a, bc));
  Vec3 m = cross(n, bc);
  double d2 = bond * std::sin(ang);
  Vec3 d = bc * (-bond * std::cos(ang)) + m * (d2 * std::cos(dih)) +
           n * (d2 * std::sin(dih));
  return c + d;
}

struct Atom {
  std::string name;
  Vec3 pos;
  char element;
};

struct Residue {
  std::string res_name;
  char chain;
  int res_id;
  Vec3 ca;
  std::vector<Atom> atoms;  // rebuilt atoms (includes CA)
};

// ---------------------------------------------------------------------------
// side-chain internal coordinates
// entry: atom name, three reference atoms, bond, angle, dihedral
struct IC {
  const char *atom;
  const char *a, *b, *c;  // dihedral(atom, c, b, a); bonded to c
  double bond, angle, dihedral;
};

// Most-common-rotamer internal coordinates, standard bond geometry.
const std::map<std::string, std::vector<IC>> &sidechain_table() {
  static const std::map<std::string, std::vector<IC>> t = {
      {"ALA", {}},
      {"SER", {{"OG", "N", "CA", "CB", 1.417, 110.8, 62}}},
      {"CYS", {{"SG", "N", "CA", "CB", 1.808, 113.8, -65}}},
      {"THR",
       {{"OG1", "N", "CA", "CB", 1.433, 109.6, 62},
        {"CG2", "N", "CA", "CB", 1.521, 110.5, -178}}},
      {"VAL",
       {{"CG1", "N", "CA", "CB", 1.527, 110.5, 175},
        {"CG2", "N", "CA", "CB", 1.527, 110.5, -63}}},
      {"ILE",
       {{"CG1", "N", "CA", "CB", 1.530, 110.4, -65},
        {"CG2", "N", "CA", "CB", 1.521, 110.5, 174},
        {"CD1", "CA", "CB", "CG1", 1.513, 113.8, 170}}},
      {"LEU",
       {{"CG", "N", "CA", "CB", 1.530, 116.3, -65},
        {"CD1", "CA", "CB", "CG", 1.521, 110.7, 175},
        {"CD2", "CA", "CB", "CG", 1.521, 110.7, -65}}},
      {"MET",
       {{"CG", "N", "CA", "CB", 1.520, 114.1, -65},
        {"SD", "CA", "CB", "CG", 1.803, 112.7, 180},
        {"CE", "CB", "CG", "SD", 1.791, 100.9, 75}}},
      {"PRO",
       {{"CG", "N", "CA", "CB", 1.492, 104.5, -28},
        {"CD", "CA", "CB", "CG", 1.503, 106.1, 36}}},
      {"PHE",
       {{"CG", "N", "CA", "CB", 1.502, 113.8, -65},
        {"CD1", "CA", "CB", "CG", 1.384, 120.8, 90},
        {"CD2", "CA", "CB", "CG", 1.384, 120.8, -90},
        {"CE1", "CB", "CG", "CD1", 1.382, 120.8, 180},
        {"CE2", "CB", "CG", "CD2", 1.382, 120.8, 180},
        {"CZ", "CG", "CD1", "CE1", 1.382, 120.0, 0}}},
      {"TYR",
       {{"CG", "N", "CA", "CB", 1.512, 113.9, -65},
        {"CD1", "CA", "CB", "CG", 1.389, 120.8, 90},
        {"CD2", "CA", "CB", "CG", 1.389, 120.8, -90},
        {"CE1", "CB", "CG", "CD1", 1.382, 121.1, 180},
        {"CE2", "CB", "CG", "CD2", 1.382, 121.1, 180},
        {"CZ", "CG", "CD1", "CE1", 1.378, 119.5, 0},
        {"OH", "CD1", "CE1", "CZ", 1.376, 119.9, 180}}},
      {"TRP",
       {{"CG", "N", "CA", "CB", 1.498, 113.6, -65},
        {"CD1", "CA", "CB", "CG", 1.365, 126.9, 95},
        {"CD2", "CA", "CB", "CG", 1.433, 126.7, -85},
        {"NE1", "CB", "CG", "CD1", 1.374, 110.2, 180},
        {"CE2", "CB", "CG", "CD2", 1.409, 107.2, 180},
        {"CE3", "CB", "CG", "CD2", 1.398, 133.9, 0},
        {"CZ2", "CG", "CD2", "CE2", 1.394, 122.4, 180},
        {"CZ3", "CG", "CD2", "CE3", 1.382, 118.6, 180},
        {"CH2", "CD2", "CE2", "CZ2", 1.368, 117.5, 0}}},
      {"ASP",
       {{"CG", "N", "CA", "CB", 1.516, 113.0, -70},
        {"OD1", "CA", "CB", "CG", 1.249, 118.4, -15},
        {"OD2", "CA", "CB", "CG", 1.249, 118.4, 165}}},
      {"ASN",
       {{"CG", "N", "CA", "CB", 1.516, 112.7, -65},
        {"OD1", "CA", "CB", "CG", 1.231, 120.8, -20},
        {"ND2", "CA", "CB", "CG", 1.328, 116.5, 160}}},
      {"GLU",
       {{"CG", "N", "CA", "CB", 1.520, 114.1, -65},
        {"CD", "CA", "CB", "CG", 1.516, 112.6, 180},
        {"OE1", "CB", "CG", "CD", 1.249, 118.4, 0},
        {"OE2", "CB", "CG", "CD", 1.249, 118.4, 180}}},
      {"GLN",
       {{"CG", "N", "CA", "CB", 1.520, 114.1, -65},
        {"CD", "CA", "CB", "CG", 1.516, 112.6, 180},
        {"OE1", "CB", "CG", "CD", 1.231, 120.8, 0},
        {"NE2", "CB", "CG", "CD", 1.328, 116.5, 180}}},
      {"LYS",
       {{"CG", "N", "CA", "CB", 1.520, 114.1, -65},
        {"CD", "CA", "CB", "CG", 1.520, 111.3, 180},
        {"CE", "CB", "CG", "CD", 1.508, 111.3, 180},
        {"NZ", "CG", "CD", "CE", 1.489, 111.5, 180}}},
      {"ARG",
       {{"CG", "N", "CA", "CB", 1.520, 114.1, -65},
        {"CD", "CA", "CB", "CG", 1.520, 111.3, 180},
        {"NE", "CB", "CG", "CD", 1.461, 112.0, 180},
        {"CZ", "CG", "CD", "NE", 1.329, 124.2, 180},
        {"NH1", "CD", "NE", "CZ", 1.326, 120.0, 0},
        {"NH2", "CD", "NE", "CZ", 1.326, 120.0, 180}}},
      {"HIS",
       {{"CG", "N", "CA", "CB", 1.492, 113.8, -65},
        {"ND1", "CA", "CB", "CG", 1.380, 122.7, -70},
        {"CD2", "CA", "CB", "CG", 1.354, 131.1, 110},
        {"CE1", "CB", "CG", "ND1", 1.326, 109.3, 180},
        {"NE2", "CB", "CG", "CD2", 1.373, 107.2, 180}}},
      {"GLY", {}},
  };
  return t;
}

char element_of(const std::string &name) {
  for (char c : name) {
    if (!isdigit(c)) return c == 'H' ? 'H' : c;
  }
  return 'C';
}

// ---------------------------------------------------------------------------
// PDB IO

struct CAChainFragment {
  std::vector<Residue> residues;
};

std::vector<CAChainFragment> read_ca_pdb(const std::string &path) {
  std::ifstream in(path);
  std::vector<CAChainFragment> frags;
  CAChainFragment cur;
  char last_chain = 0;
  int last_rid = -1000000;
  std::string line;
  while (std::getline(in, line)) {
    if (line.compare(0, 4, "ATOM") != 0 || line.size() < 54) continue;
    std::string name = line.substr(12, 4);
    name.erase(0, name.find_first_not_of(' '));
    name.erase(name.find_last_not_of(' ') + 1);
    if (name != "CA") continue;
    Residue r;
    r.res_name = line.substr(17, 3);
    r.chain = line[21];
    r.res_id = std::stoi(line.substr(22, 4));
    r.ca = {std::stod(line.substr(30, 8)), std::stod(line.substr(38, 8)),
            std::stod(line.substr(46, 8))};
    int gap = r.res_id - last_rid;
    if (!cur.residues.empty() && (r.chain != last_chain || (gap != 0 && gap != 1))) {
      frags.push_back(cur);
      cur = CAChainFragment{};
    }
    // also split on physically impossible CA-CA distances
    if (!cur.residues.empty() && dist(cur.residues.back().ca, r.ca) > 4.6) {
      frags.push_back(cur);
      cur = CAChainFragment{};
    }
    last_chain = r.chain;
    last_rid = r.res_id;
    cur.residues.push_back(r);
  }
  if (!cur.residues.empty()) frags.push_back(cur);
  return frags;
}

// ---------------------------------------------------------------------------
// backbone building
//
// Interior peptide planes come from a statistical placement table indexed by
// the local 4-CA-window geometry (r13a, r13b, chirality-signed r14) — the
// same descriptor family as PULCHRA's binned fragment library
// (pulchra.c:1582), but with our own binning/frame/layout; the table is
// generated by calibrate_backbone.py (behavioral calibration against the
// reference tool on synthetic traces).  Terminal peptides, which lack a full
// window, fall back to ideal trans-peptide geometry continued from the first
// placed interior plane.

#include "backbone_table.h"

// local frame of the peptide between p1 and p2 with p0 the preceding CA:
// rows (u, e1, e2) — must match calibrate_backbone.window_frame.
struct Frame {
  Vec3 u, e1, e2;
  Vec3 to_world(const Vec3 &origin, double x, double y, double z) const {
    return origin + u * x + e1 * y + e2 * z;
  }
};

Frame window_frame(const Vec3 &p0, const Vec3 &p1, const Vec3 &p2) {
  Frame f;
  f.u = unit(p2 - p1);
  Vec3 w = p0 - p1;
  Vec3 e1 = w - f.u * dot(w, f.u);
  if (norm(e1) < 1e-9) e1 = cross(f.u, Vec3(1, 0, 0));
  if (norm(e1) < 1e-9) e1 = cross(f.u, Vec3(0, 1, 0));
  f.e1 = unit(e1);
  f.e2 = cross(f.u, f.e1);
  return f;
}

// trilinear lookup of M local-frame coordinates from a binned table
void table_lookup(const float *table, int M, double r13a, double r13b,
                  double r14s, double *out) {
  auto grid = [&](double v, double lo, double step, int n, int &i0,
                  double &t) {
    double g = (v - lo) / step - 0.5;  // bin-center aligned
    if (g < 0) g = 0;
    if (g > n - 1.001) g = n - 1.001;
    i0 = (int)g;
    t = g - i0;
  };
  int ia, ib, ic;
  double ta, tb, tc;
  grid(r13a, kR13Lo, kR13Step, kR13N, ia, ta);
  grid(r13b, kR13Lo, kR13Step, kR13N, ib, tb);
  grid(r14s, kR14Lo, kR14Step, kR14N, ic, tc);
  for (int m = 0; m < M; ++m) out[m] = 0;
  for (int da = 0; da < 2; ++da)
    for (int db = 0; db < 2; ++db)
      for (int dc = 0; dc < 2; ++dc) {
        double w = (da ? ta : 1 - ta) * (db ? tb : 1 - tb) * (dc ? tc : 1 - tc);
        const float *cell =
            &table[(((ia + da) * kR13N + (ib + db)) * kR14N + (ic + dc)) * M];
        for (int m = 0; m < M; ++m) out[m] += w * cell[m];
      }
}

// chirality-signed r14 descriptors of a 4-CA window
void window_desc(const Vec3 &p0, const Vec3 &p1, const Vec3 &p2,
                 const Vec3 &p3, double &r13a, double &r13b, double &r14s) {
  r13a = dist(p2, p0);
  r13b = dist(p3, p1);
  double r14 = dist(p3, p0);
  double sign = dot(cross(p1 - p0, p2 - p1), p3 - p2);
  r14s = sign >= 0 ? r14 : -r14;
}

void build_backbone(CAChainFragment &frag) {
  size_t n = frag.residues.size();
  std::vector<Vec3> C(n), N(n), O(n);
  std::vector<bool> hasC(n, false), hasN(n, false), hasO(n, false);

  // interior peptides i -> i+1 (need CA(i-1) and CA(i+2))
  for (size_t i = 1; i + 2 < n; ++i) {
    const Vec3 &p0 = frag.residues[i - 1].ca;
    const Vec3 &p1 = frag.residues[i].ca;
    const Vec3 &p2 = frag.residues[i + 1].ca;
    const Vec3 &p3 = frag.residues[i + 2].ca;
    double r13a, r13b, r14s;
    window_desc(p0, p1, p2, p3, r13a, r13b, r14s);
    double loc[9];
    table_lookup(kBackboneTable, 9, r13a, r13b, r14s, loc);
    Frame f = window_frame(p0, p1, p2);
    C[i] = f.to_world(p1, loc[0], loc[1], loc[2]);
    O[i] = f.to_world(p1, loc[3], loc[4], loc[5]);
    N[i + 1] = f.to_world(p1, loc[6], loc[7], loc[8]);
    hasC[i] = hasO[i] = hasN[i + 1] = true;
  }

  if (n >= 4) {
    // head: N(0), C(0), O(0), N(1) from the head table over window CA0..CA3
    {
      const Vec3 &p0 = frag.residues[0].ca;
      const Vec3 &p1 = frag.residues[1].ca;
      const Vec3 &p2 = frag.residues[2].ca;
      const Vec3 &p3 = frag.residues[3].ca;
      double r13a, r13b, r14s;
      window_desc(p0, p1, p2, p3, r13a, r13b, r14s);
      double loc[12];
      table_lookup(kHeadTable, 12, r13a, r13b, r14s, loc);
      Frame f = window_frame(p2, p0, p1);  // origin CA0, u to CA1, e1 via CA2
      N[0] = f.to_world(p0, loc[0], loc[1], loc[2]);
      C[0] = f.to_world(p0, loc[3], loc[4], loc[5]);
      O[0] = f.to_world(p0, loc[6], loc[7], loc[8]);
      N[1] = f.to_world(p0, loc[9], loc[10], loc[11]);
      hasN[0] = hasC[0] = hasO[0] = hasN[1] = true;
    }
    // tail: C(l-1), O(l-1), N(l), C(l), O(l) from the tail table
    {
      size_t l = n - 1;
      const Vec3 &q0 = frag.residues[l - 3].ca;
      const Vec3 &q1 = frag.residues[l - 2].ca;
      const Vec3 &q2 = frag.residues[l - 1].ca;
      const Vec3 &q3 = frag.residues[l].ca;
      double r13a, r13b, r14s;
      window_desc(q0, q1, q2, q3, r13a, r13b, r14s);
      double loc[15];
      table_lookup(kTailTable, 15, r13a, r13b, r14s, loc);
      Frame f = window_frame(q1, q2, q3);  // origin CA(l-1), u to CA(l)
      C[l - 1] = f.to_world(q2, loc[0], loc[1], loc[2]);
      O[l - 1] = f.to_world(q2, loc[3], loc[4], loc[5]);
      N[l] = f.to_world(q2, loc[6], loc[7], loc[8]);
      C[l] = f.to_world(q2, loc[9], loc[10], loc[11]);
      O[l] = f.to_world(q2, loc[12], loc[13], loc[14]);
      hasC[l - 1] = hasO[l - 1] = hasN[l] = hasC[l] = hasO[l] = true;
    }
  } else {
    // short fragments (<4 CA): ideal-geometry fallback
    for (size_t i = 0; i + 1 < n; ++i) {
      Vec3 ca0 = frag.residues[i].ca;
      Vec3 ca1 = frag.residues[i + 1].ca;
      Vec3 u = unit(ca1 - ca0);
      Vec3 refv = (i + 2 < n) ? frag.residues[i + 2].ca - ca1 : Vec3(0, 0, 1);
      Vec3 p = refv - u * dot(refv, u);
      if (norm(p) < 1e-6) p = cross(u, Vec3(1, 0, 0));
      Vec3 e1 = unit(p);
      C[i] = ca0 + u * 1.426 + e1 * 0.540;
      N[i + 1] = ca0 + u * 2.394 + e1 * 0.387;
      hasC[i] = true;
      hasN[i + 1] = true;
    }
    if (n >= 2) {
      Vec3 u = unit(frag.residues[0].ca - frag.residues[1].ca);
      N[0] = frag.residues[0].ca + u * 1.458;
      hasN[0] = true;
      size_t l = n - 1;
      C[l] = hasN[l] ? nerf(frag.residues[l - 1].ca, N[l],
                            frag.residues[l].ca, 1.525, 111.0, -120.0)
                     : frag.residues[l].ca + Vec3(1.525, 0, 0);
      hasC[l] = true;
    } else if (n == 1) {
      N[0] = frag.residues[0].ca + Vec3(-1.458, 0, 0);
      C[0] = frag.residues[0].ca + Vec3(1.525, 0, 0);
      hasN[0] = hasC[0] = true;
    }
    for (size_t i = 0; i < n; ++i) {
      if (hasO[i]) continue;
      if (i + 1 < n && hasN[i + 1]) {
        O[i] = nerf(frag.residues[i].ca, N[i + 1], C[i], 1.231, 120.5, 180.0);
      } else {
        O[i] = nerf(N[i], frag.residues[i].ca, C[i], 1.231, 120.5, 0.0);
      }
      hasO[i] = true;
    }
  }

  for (size_t i = 0; i < n; ++i) {
    Residue &r = frag.residues[i];
    r.atoms.push_back({"N", N[i], 'N'});
    r.atoms.push_back({"CA", r.ca, 'C'});
    r.atoms.push_back({"C", C[i], 'C'});
    r.atoms.push_back({"O", O[i], 'O'});
  }
}

// ---------------------------------------------------------------------------
// side chains

const char *kAA3[20] = {"ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS",
                        "ILE", "LYS", "LEU", "MET", "ASN", "PRO", "GLN",
                        "ARG", "SER", "THR", "VAL", "TRP", "TYR"};

int aa_index(const std::string &res) {
  for (int i = 0; i < 20; ++i)
    if (res == kAA3[i]) return i;
  return -1;
}

// chi1-defining gamma atom per residue (dihedral N-CA-CB-<gamma>)
const std::map<std::string, std::string> &gamma_atom() {
  static const std::map<std::string, std::string> g = {
      {"SER", "OG"},  {"CYS", "SG"},  {"THR", "OG1"}, {"VAL", "CG1"},
      {"ILE", "CG1"}, {"LEU", "CG"},  {"MET", "CG"},  {"PRO", "CG"},
      {"PHE", "CG"},  {"TYR", "CG"},  {"TRP", "CG"},  {"ASP", "CG"},
      {"ASN", "CG"},  {"GLU", "CG"},  {"GLN", "CG"},  {"LYS", "CG"},
      {"ARG", "CG"},  {"HIS", "CG"}};
  return g;
}

// chi2-defining delta atom per residue (dihedral CA-CB-<gamma>-<delta>)
const std::map<std::string, std::string> &delta_atom() {
  static const std::map<std::string, std::string> d = {
      {"ILE", "CD1"}, {"LEU", "CD1"}, {"MET", "SD"},  {"PHE", "CD1"},
      {"TYR", "CD1"}, {"TRP", "CD1"}, {"ASP", "OD1"}, {"ASN", "OD1"},
      {"GLU", "CD"},  {"GLN", "CD"},  {"LYS", "CD"},  {"ARG", "CD"},
      {"HIS", "ND1"}, {"PRO", "CD"}};
  return d;
}

double wrap_deg(double a) {
  while (a > 180) a -= 360;
  while (a < -180) a += 360;
  return a;
}

double dihedral_deg(const Vec3 &p0, const Vec3 &p1, const Vec3 &p2,
                    const Vec3 &p3) {
  Vec3 b1 = p1 - p0, b2 = p2 - p1, b3 = p3 - p2;
  Vec3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  Vec3 m = cross(n1, unit(b2));
  return std::atan2(dot(m, n2), dot(n1, n2)) * 180.0 / M_PI;
}

// phi/psi-dependent chi lookup (tables calibrated against the reference
// tool's rotamer choices — the counterpart of PULCHRA's backbone-dependent
// rotamer library, pulchra.c:1818-1933)
double chi_from_table(const float *table, int ai, double phi, double psi) {
  int pi = (int)((phi + 180.0) / 30.0);
  int si = (int)((psi + 180.0) / 30.0);
  pi = std::min(std::max(pi, 0), kPhiN - 1);
  si = std::min(std::max(si, 0), kPhiN - 1);
  return table[(ai * kPhiN + pi) * kPhiN + si];
}

// ---------------------------------------------------------------------------
// excluded-volume relaxation on a spatial hash grid

struct HashGrid {
  double cell;
  std::unordered_map<long long, std::vector<int>> cells;
  explicit HashGrid(double c) : cell(c) {}
  long long key(const Vec3 &p) const {
    long long ix = (long long)std::floor(p.x / cell) + 100000;
    long long iy = (long long)std::floor(p.y / cell) + 100000;
    long long iz = (long long)std::floor(p.z / cell) + 100000;
    return (ix * 2000003LL + iy) * 2000003LL + iz;
  }
  void insert(const Vec3 &p, int id) { cells[key(p)].push_back(id); }
  template <typename F>
  void neighbors(const Vec3 &p, F f) const {
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          Vec3 q = p + Vec3(dx * cell, dy * cell, dz * cell);
          auto it = cells.find(key(q));
          if (it == cells.end()) continue;
          for (int id : it->second) f(id);
        }
  }
};

// Residues whose chi2 candidates are worth exploring during rotamer
// selection (long flexible chains; rings/branched residues keep the
// calibrated chi2, which the golden tests anchor).
inline bool chi2_flexible(const std::string &rn) {
  return rn == "LYS" || rn == "ARG" || rn == "MET" || rn == "GLU" ||
         rn == "GLN";
}

// ---------------------------------------------------------------------------
// calibrated side-chain placement table (round-5): frame-relative
// Cartesian conformations keyed by the local CA-geometry bins
// (b13_1, b13_2, b14) — behaviorally calibrated against the reference
// binary by calibrate_sidechains.py.  The bins and the nearest-entry
// metric |db1| + |db2| + 0.2*|db14| mirror the reference tool's own
// selection function (pulchra.c:1696-1713, 2030-2060), so with the
// same inputs our nearest table key reproduces its rotamer choice.
#include "sidechain_table.h"

int sc_type_index(const std::string &rn) {
  for (int i = 0; i < kScNumTypes; ++i)
    if (rn == kScTypeNames[i]) return i;
  return -1;
}

// local CA-geometry bins at residue i (pulchra.c:1696-1713 semantics)
void sc_bins(const Vec3 &p0, const Vec3 &p1, const Vec3 &p2, const Vec3 &p3,
             int *b1, int *b2, int *b14) {
  double r13_1 = dist(p0, p2);
  double r13_2 = dist(p1, p3);
  double r14 = dist(p0, p3);
  if (dot(cross(p1 - p0, p2 - p1), p3 - p2) < 0) r14 = -r14;
  *b1 = std::min(std::max((int)((r13_1 - 4.6) / 0.3), 0), 9);
  *b2 = std::min(std::max((int)((r13_2 - 4.6) / 0.3), 0), 9);
  *b14 = std::min(std::max((int)((r14 + 11.0) / 0.3), 0), 73);
}

// side-chain local frame rows (must match calibrate_sidechains.sc_frame)
void sc_frame_rows(const Vec3 &pm1, const Vec3 &p, const Vec3 &pp1,
                   Vec3 *f1, Vec3 *f2, Vec3 *f3) {
  *f1 = unit(pp1 - pm1);
  Vec3 c = cross(pp1 - p, p - pm1);
  *f2 = norm(c) > 1e-9 ? unit(c) : unit(cross(*f1, Vec3(1, 0, 0)));
  *f3 = cross(*f1, *f2);
}

// nearest-key lookup (the reference tool's own metric, pulchra.c:2038)
int sc_lookup(int ti, int b1, int b2, int b14) {
  const ScKey *keys = kScKeys[ti];
  int nk = kScKeyCounts[ti];
  double best = 1e9;
  int conf = -1;
  for (int j = 0; j < nk; ++j) {
    double hit = std::abs((int)keys[j].b1 - b1) +
                 std::abs((int)keys[j].b2 - b2) +
                 0.2 * std::abs((int)keys[j].b14 - b14);
    if (hit < best) {
      best = hit;
      conf = keys[j].conf;
    }
  }
  return conf;
}

void build_sidechains(CAChainFragment &frag) {
  const auto &table = sidechain_table();
  size_t n = frag.residues.size();

  // Excluded-volume context (the counterpart of PULCHRA's rotamer
  // excluded-volume optimization, pulchra.c:1933-2100): every candidate
  // rotamer is scored against the fragment's backbone plus the side
  // chains placed so far (sequential placement), and the best-scoring
  // candidate wins.  The calibrated (phi, psi)-binned rotamer carries a
  // zero prior, so in the clash-free case the selection is EXACTLY the
  // calibrated choice — alternatives engage only when it collides.
  struct Ctx { Vec3 pos; int res; };
  std::vector<Ctx> ctx;
  HashGrid grid(3.0);
  auto add_ctx = [&](const Vec3 &p, int res) {
    grid.insert(p, (int)ctx.size());
    ctx.push_back({p, res});
  };
  for (size_t ri = 0; ri < n; ++ri)
    for (const Atom &a : frag.residues[ri].atoms) add_ctx(a.pos, (int)ri);

  const double kClash = 2.8;  // soft excluded-volume radius
  auto clash_score = [&](const std::vector<std::pair<std::string, Vec3>>
                             &atoms, int ri) {
    double sc = 0;
    for (const auto &nv : atoms)
      grid.neighbors(nv.second, [&](int j) {
        if (std::abs(ctx[j].res - ri) <= 1) return;  // self/bonded range
        Vec3 d = nv.second - ctx[j].pos;
        double dn = norm(d);
        if (dn < kClash) {
          double v = kClash - dn;
          sc += v * v;
        }
      });
    return sc;
  };

  for (size_t ri = 0; ri < n; ++ri) {
    Residue &r = frag.residues[ri];
    std::unordered_map<std::string, Vec3> pos;
    for (const Atom &a : r.atoms) pos[a.name] = a.pos;
    if (r.res_name == "GLY") continue;
    // CB: ideal L-amino-acid tetrahedral geometry.  The improper dihedral
    // N-C-CA-CB must come out ~ +123 deg (L); -122.55 here by the
    // nerf(a=C, b=N, c=CA) convention (dihedral measured C->N->CA->CB).
    Vec3 cb = nerf(pos["C"], pos["N"], pos["CA"], 1.530, 110.4, -122.55);
    pos["CB"] = cb;

    // calibrated-table placement (needs the full CA window i-2..i+1)
    std::vector<std::pair<std::string, Vec3>> table_atoms;
    int ti = sc_type_index(r.res_name);
    if (ti >= 0 && ri >= 2 && ri + 1 < n && kScKeyCounts[ti] > 0) {
      int b1, b2, b14;
      sc_bins(frag.residues[ri - 2].ca, frag.residues[ri - 1].ca, r.ca,
              frag.residues[ri + 1].ca, &b1, &b2, &b14);
      Vec3 f1, f2, f3;
      sc_frame_rows(frag.residues[ri - 1].ca, r.ca,
                    frag.residues[ri + 1].ca, &f1, &f2, &f3);
      int conf = sc_lookup(ti, b1, b2, b14);
      int nat = kScAtomCounts[ti];
      if (conf >= 0) {
        const float *co = kScConfs[ti] + (size_t)conf * nat * 3;
        for (int j = 0; j < nat; ++j) {
          Vec3 p = r.ca + f1 * co[3 * j] + f2 * co[3 * j + 1] +
                   f3 * co[3 * j + 2];
          table_atoms.emplace_back(kScAtomNames[ti][j], p);
        }
      }
    }

    auto it = table.find(r.res_name);
    if (it == table.end() && table_atoms.empty()) {
      // no IC entry and no table: commit the ideal CB alone
      r.atoms.push_back({"CB", cb, 'C'});
      add_ctx(cb, (int)ri);
      continue;
    }

    const bool have_ic = it != table.end();

    // IC-table chi definitions (independent of phi/psi availability)
    double chi1_def = 0, chi2_def = 0;
    bool has1 = false, has2 = false;
    int ai = aa_index(r.res_name);
    auto git = gamma_atom().find(r.res_name);
    auto dit = delta_atom().find(r.res_name);
    if (have_ic && git != gamma_atom().end())
      for (const IC &ic : it->second) {
        if (ic.atom == git->second) {
          chi1_def = ic.dihedral;
          has1 = true;
        }
        if (dit != delta_atom().end() && ic.atom == dit->second) {
          chi2_def = ic.dihedral;
          has2 = true;
        }
      }

    // backbone-dependent rotamer: shift the gamma-level (chi1) and
    // delta-level (chi2) dihedrals of the IC table toward the calibrated
    // (phi, psi)-binned values
    double d1 = 0, d2 = 0;
    if (ai >= 0 && has1 && ri > 0 && ri + 1 < n) {
      // phi needs C(i-1); psi needs N(i+1)
      const Vec3 *prevC = nullptr, *nextN = nullptr;
      for (const Atom &a : frag.residues[ri - 1].atoms)
        if (a.name == "C") prevC = &a.pos;
      for (const Atom &a : frag.residues[ri + 1].atoms)
        if (a.name == "N") nextN = &a.pos;
      if (prevC && nextN) {
        double phi = dihedral_deg(*prevC, pos["N"], pos["CA"], pos["C"]);
        double psi = dihedral_deg(pos["N"], pos["CA"], pos["C"], *nextN);
        // table angles are in the measuring convention of dihedral_deg,
        // which is the NEGATIVE of nerf's dihedral argument (verified
        // numerically) — negate when converting to IC-table shifts
        d1 = wrap_deg(-chi_from_table(kChi1Table, ai, phi, psi) - chi1_def);
        if (has2) {
          d2 = wrap_deg(-chi_from_table(kChi2Table, ai, phi, psi) - chi2_def);
          if (r.res_name == "PHE" || r.res_name == "TYR") {
            // ring-flip symmetry: fold the shift into (-90, 90]
            if (d2 > 90) d2 -= 180;
            if (d2 < -90) d2 += 180;
          }
        }
      }
    }

    auto place = [&](double dd1, double dd2) {
      // legacy NeRF placement — always includes the ideal CB so all
      // candidate families carry a complete side chain
      std::vector<std::pair<std::string, Vec3>> out;
      out.emplace_back("CB", cb);
      if (!have_ic) return out;
      std::unordered_map<std::string, Vec3> p2 = pos;
      for (const IC &ic : it->second) {
        auto pa = p2.find(ic.a), pb = p2.find(ic.b), pc = p2.find(ic.c);
        if (pa == p2.end() || pb == p2.end() || pc == p2.end()) continue;
        double dih = ic.dihedral;
        if (std::strcmp(ic.c, "CB") == 0) dih = wrap_deg(dih + dd1);
        else if (std::strcmp(ic.b, "CB") == 0) dih = wrap_deg(dih + dd2);
        Vec3 p = nerf(pa->second, pb->second, pc->second, ic.bond, ic.angle,
                      dih);
        p2[ic.atom] = p;
        out.emplace_back(ic.atom, p);
      }
      return out;
    };

    // Candidate set, in prior order:
    //   1. the calibrated-table conformation at the nearest CA-geometry
    //      key (prior 0 — the reference tool's own choice; wins
    //      whenever clash-free),
    //   2. the second-nearest distinct table conformation,
    //   3. the legacy NeRF placements: (phi, psi)-calibrated chi, then
    //      the canonical chi1 wells (g-, g+, t), crossed with chi2
    //      wells for long flexible chains — the clash-escape set.
    struct Cand { double d1, d2, prior; };
    std::vector<Cand> cands;
    if (have_ic) {
      cands.push_back({d1, d2, 0.20});
      if (has1) {
        for (double chi1c : {-60.0, 60.0, 180.0}) {
          double d1c = wrap_deg(-chi1c - chi1_def);
          cands.push_back({d1c, d2, 0.35});
          if (has2 && chi2_flexible(r.res_name))
            for (double chi2c : {-60.0, 60.0, 180.0})
              cands.push_back({d1c, wrap_deg(-chi2c - chi2_def), 0.50});
        }
      }
    } else if (table_atoms.empty()) {
      cands.push_back({0, 0, 0.20});  // CB only
    }

    // The nearest-key table conformation is the reference tool's own
    // rotamer choice and commits outright — clash-aware selection here
    // was measured to DIVERGE from the oracle (chi1 agreement 0.83
    // table-only vs 0.77-0.79 with soft/hard-gated selection on the
    // golden example) while gaining nothing: the downstream
    // excluded-volume relaxation keeps final hard clashes at zero from
    // either starting point (the reference tool does the same — its
    // rotamer pick has no clash term in CA-only mode, pulchra.c:
    // 2030-2123, and its exvol pass runs after).  The clash-scored
    // legacy NeRF candidate set remains the fallback for residues
    // without table coverage (fragment terminals, unknown types).
    double best = 1e30;
    std::vector<std::pair<std::string, Vec3>> best_atoms;
    if (!table_atoms.empty()) {
      best = 0.0;
      best_atoms = std::move(table_atoms);
    } else {
      for (const Cand &c : cands) {
        if (best <= c.prior + 1e-12) break;  // cannot improve
        auto atoms = place(c.d1, c.d2);
        double sc = clash_score(atoms, (int)ri) + c.prior;
        if (sc < best - 1e-12) {
          best = sc;
          best_atoms = std::move(atoms);
        }
      }
    }
    for (const auto &nv : best_atoms) {
      r.atoms.push_back({nv.first, nv.second, element_of(nv.first)});
      add_ctx(nv.second, (int)ri);
    }
  }
}

// ---------------------------------------------------------------------------
// chirality check/fix: every residue must be L (improper dihedral
// N->C->CA->CB ~ +123 deg).  D residues get their entire side chain
// reflected through the N/CA/C plane (counterpart of pulchra.c:2648).

int chirality_fix(std::vector<CAChainFragment> &frags) {
  int fixed = 0;
  for (auto &f : frags) {
    for (auto &r : f.residues) {
      Vec3 N, CA, C, CB;
      bool hasCB = false;
      for (const Atom &a : r.atoms) {
        if (a.name == "N") N = a.pos;
        else if (a.name == "CA") CA = a.pos;
        else if (a.name == "C") C = a.pos;
        else if (a.name == "CB") { CB = a.pos; hasCB = true; }
      }
      if (!hasCB) continue;
      // under dihedral_deg's sign convention the L improper N->C->CA->CB
      // is ~ -123 deg (PULCHRA golden measures -124.9 +- 13)
      double imp = dihedral_deg(N, C, CA, CB);
      if (imp < 0) continue;  // L — correct
      Vec3 nrm = unit(cross(N - CA, C - CA));
      for (Atom &a : r.atoms) {
        if (a.name == "N" || a.name == "CA" || a.name == "C" ||
            a.name == "O")
          continue;
        double h = dot(a.pos - CA, nrm);
        a.pos = a.pos - nrm * (2.0 * h);
      }
      ++fixed;
    }
  }
  return fixed;
}

// ---------------------------------------------------------------------------
// excluded-volume relaxation on a spatial hash grid (HashGrid defined
// above build_sidechains, which also uses it for rotamer selection)

void relax_clashes(std::vector<CAChainFragment> &frags, int iters = 3) {
  struct Ref {
    Atom *atom;
    int res_uid;
    bool backbone;
  };
  std::vector<Ref> all;
  int uid = 0;
  for (auto &f : frags) {
    for (auto &r : f.residues) {
      for (auto &a : r.atoms) {
        bool bb = a.name == "N" || a.name == "CA" || a.name == "C" ||
                  a.name == "O";
        all.push_back({&a, uid, bb});
      }
      ++uid;
    }
  }
  const double clash = 2.6;
  for (int it = 0; it < iters; ++it) {
    HashGrid grid(3.0);
    for (size_t i = 0; i < all.size(); ++i) grid.insert(all[i].atom->pos, (int)i);
    std::vector<Vec3> shift(all.size());
    for (size_t i = 0; i < all.size(); ++i) {
      if (all[i].backbone) continue;  // only move side-chain atoms
      Vec3 p = all[i].atom->pos;
      Vec3 s(0, 0, 0);
      grid.neighbors(p, [&](int j) {
        if ((size_t)j == i) return;
        if (std::abs(all[j].res_uid - all[i].res_uid) <= 1 &&
            all[j].res_uid != all[i].res_uid)
          return;  // skip bonded neighbors' residues
        if (all[j].res_uid == all[i].res_uid) return;
        Vec3 d = p - all[j].atom->pos;
        double dn = norm(d);
        if (dn < clash && dn > 1e-6) {
          s = s + unit(d) * ((clash - dn) * 0.4);
        }
      });
      shift[i] = s;
    }
    for (size_t i = 0; i < all.size(); ++i)
      all[i].atom->pos = all[i].atom->pos + shift[i];
  }
}

// ---------------------------------------------------------------------------
// CA-position optimization (the reference tool's default mode, skipped by
// MICA via `pulchra -c` — reference modeler.py:371; pulchra.c:801).
//
// Same published energy model as PULCHRA's ca_optimize — four terms over
// the CA trace:
//   bond      k_b (d - 3.8)^2            consecutive CAs within a fragment
//   restraint k_r |x - x0|^2             only beyond `max_shift` from input
//   angle     k_a (theta - clamp(theta, 80deg, 150deg))^2
//   xvol      k_x (d - 3.5)^2            pairs |i-j|>2 (any fragment), d<3.5
// but an independent implementation: deterministic Armijo-backtracking
// gradient descent (no RNG jitter — the reference perturbs each line-search
// step by rnd()), a cell list for the excluded-volume pairs (the reference
// is O(N^2) per energy evaluation), and a consistent xvol energy/gradient
// pair (the reference's xvol energy is d^2 while its gradient is that of
// 4 (d - 3.5)^2; we use the harmonic the gradient implies).

struct CAOptStats {
  double e0 = 0, e1 = 0;
  int iters = 0;
};

CAOptStats ca_optimize(std::vector<CAChainFragment> &frags,
                       double max_shift = 3.0, int max_iters = 100) {
  const double K_BOND = 10.0, K_ANG = 20.0, K_REST = 0.01, K_XVOL = 10.0;
  const double D_BOND = 3.8, D_XVOL = 3.5;
  const double TH_LO = 80.0 * M_PI / 180.0, TH_HI = 150.0 * M_PI / 180.0;

  struct Node {
    Vec3 *pos;
    Vec3 init;
    int frag, idx;  // fragment id and index within the fragment
  };
  std::vector<Node> ca;
  for (size_t f = 0; f < frags.size(); ++f)
    for (size_t i = 0; i < frags[f].residues.size(); ++i) {
      Residue &r = frags[f].residues[i];
      ca.push_back({&r.ca, r.ca, (int)f, (int)i});
    }
  const int n = (int)ca.size();
  CAOptStats st;
  if (n < 2) return st;

  std::vector<Vec3> x(n), grad(n);
  for (int i = 0; i < n; ++i) x[i] = ca[i].init;

  // excluded-volume pair list from a cell list; rebuilt when positions
  // move, reused across line-search evaluations
  std::vector<std::pair<int, int>> xpairs;
  auto build_pairs = [&]() {
    xpairs.clear();
    HashGrid grid(D_XVOL);
    for (int i = 0; i < n; ++i) grid.insert(x[i], i);
    for (int i = 0; i < n; ++i)
      grid.neighbors(x[i], [&](int j) {
        if (j <= i) return;
        bool adjacent = ca[i].frag == ca[j].frag &&
                        std::abs(ca[i].idx - ca[j].idx) <= 2;
        if (adjacent) return;
        if (dist(x[i], x[j]) < D_XVOL + 0.5) xpairs.emplace_back(i, j);
      });
  };

  // energy and (optionally) gradient at positions p
  auto energy = [&](const std::vector<Vec3> &p, bool want_grad) {
    double e = 0;
    if (want_grad)
      for (auto &g : grad) g = Vec3(0, 0, 0);
    for (int i = 0; i < n; ++i) {
      // restraint to the input position beyond the free radius
      Vec3 d0 = p[i] - ca[i].init;
      double r0 = norm(d0);
      if (r0 > max_shift) {
        e += K_REST * r0 * r0;
        if (want_grad) grad[i] = grad[i] + d0 * (2.0 * K_REST);
      }
      // bond to the previous CA in the same fragment
      if (ca[i].idx > 0) {
        Vec3 db = p[i] - p[i - 1];
        double d = norm(db);
        double dd = d - D_BOND;
        e += K_BOND * dd * dd;
        if (want_grad && d > 1e-9) {
          Vec3 g = db * (2.0 * K_BOND * dd / d);
          grad[i] = grad[i] + g;
          grad[i - 1] = grad[i - 1] - g;
        }
      }
      // pseudo-angle window [80, 150] degrees
      if (ca[i].idx > 0 && i + 1 < n && ca[i + 1].frag == ca[i].frag &&
          ca[i + 1].idx == ca[i].idx + 1) {
        Vec3 a = p[i - 1] - p[i], b = p[i + 1] - p[i];
        double la = norm(a), lb = norm(b);
        if (la > 1e-9 && lb > 1e-9) {
          double c = dot(a, b) / (la * lb);
          c = std::max(-1.0, std::min(1.0, c));
          double th = std::acos(c);
          double diff = th < TH_LO ? th - TH_LO : (th > TH_HI ? th - TH_HI : 0.0);
          e += K_ANG * diff * diff;
          if (want_grad && diff != 0.0) {
            double s = std::sqrt(std::max(1e-12, 1.0 - c * c));
            // d(theta)/d(p): standard angle gradient
            Vec3 ga = (a * (c / la) - b * (1.0 / lb)) * (1.0 / (la * s));
            Vec3 gb = (b * (c / lb) - a * (1.0 / la)) * (1.0 / (lb * s));
            double w = 2.0 * K_ANG * diff;
            grad[i - 1] = grad[i - 1] + ga * w;
            grad[i + 1] = grad[i + 1] + gb * w;
            grad[i] = grad[i] - (ga + gb) * w;
          }
        }
      }
    }
    for (auto &pr : xpairs) {
      Vec3 d = p[pr.first] - p[pr.second];
      double r = norm(d);
      if (r < D_XVOL && r > 1e-9) {
        double dd = r - D_XVOL;
        e += K_XVOL * dd * dd;
        if (want_grad) {
          Vec3 g = d * (2.0 * K_XVOL * dd / r);
          grad[pr.first] = grad[pr.first] + g;
          grad[pr.second] = grad[pr.second] - g;
        }
      }
    }
    return e;
  };

  build_pairs();
  double e = energy(x, true);
  st.e0 = e;
  std::vector<Vec3> trial(n);
  int stall = 0;
  for (int it = 0; it < max_iters && stall < 3; ++it) {
    double gnorm2 = 0;
    for (auto &g : grad) gnorm2 += dot(g, g);
    double grms = std::sqrt(gnorm2 / n);
    if (grms < 0.01) break;
    // Armijo backtracking along -grad
    double alpha = 1.0 / std::max(1.0, std::sqrt(gnorm2));
    double e_new = e;
    bool moved = false;
    for (int ls = 0; ls < 25; ++ls) {
      for (int i = 0; i < n; ++i) trial[i] = x[i] - grad[i] * alpha;
      double et = energy(trial, false);
      if (et < e - 1e-4 * alpha * gnorm2) {
        x.swap(trial);
        e_new = et;
        moved = true;
        break;
      }
      alpha *= 0.5;
    }
    if (!moved) break;
    stall = (e - e_new < 1e-3) ? stall + 1 : 0;
    e = e_new;
    build_pairs();
    e = energy(x, true);
    st.iters = it + 1;
  }
  st.e1 = e;
  for (int i = 0; i < n; ++i) *ca[i].pos = x[i];
  return st;
}

// ---------------------------------------------------------------------------
// H-bond-aware backbone refinement (the reference tool's `-q` mode,
// pulchra.c:2996 optimize_backbone / :2732 hb_energy).  For each residue
// whose backbone amide N-H lacks a good hydrogen bond, rotate its preceding
// peptide plane (the C/O of residue i-1) about the CA(i-1)->CA(i) axis
// through +-1.0 rad in 0.1-rad steps and keep the rotation minimizing the
// DSSP electrostatic H-bond energy
//     E = -27.888 (1/d_NO + 1/d_HC - 1/d_HO - 1/d_NC)   [kcal/mol]
// with H placed 1.08 A from N anti-parallel to the preceding C=O.
// Independent implementation: cell-list acceptor search, prolines skipped
// (no amide H), deterministic scan order.

Atom *find_atom(Residue &r, const char *nm) {
  for (auto &a : r.atoms)
    if (a.name == nm) return &a;
  return nullptr;
}

double dssp_hb_energy(const Vec3 &n_pos, const Vec3 &h_pos, const Vec3 &o_pos,
                      const Vec3 &c_pos) {
  double dno = dist(n_pos, o_pos), dhc = dist(h_pos, c_pos);
  double dho = dist(h_pos, o_pos), dnc = dist(n_pos, c_pos);
  if (dno < 1e-3 || dhc < 1e-3 || dho < 1e-3 || dnc < 1e-3) return 1e3;
  return -27.888 * (1.0 / dno + 1.0 / dhc - 1.0 / dho - 1.0 / dnc);
}

struct HBStats {
  double before = 0, after = 0;
  int improved = 0;
};

HBStats hb_optimize(std::vector<CAChainFragment> &frags) {
  // flatten: donors are interior residues (have a previous residue in the
  // same fragment); acceptors are every residue's C=O
  struct RRef {
    Residue *res;
    int uid;
  };
  std::vector<RRef> all;
  int uid = 0;
  for (auto &f : frags)
    for (auto &r : f.residues) all.push_back({&r, uid++});

  auto acceptor_grid = [&]() {
    HashGrid g(5.0);
    for (size_t i = 0; i < all.size(); ++i) {
      Atom *o = find_atom(*all[i].res, "O");
      if (o) g.insert(o->pos, (int)i);
    }
    return g;
  };

  // donor energy: best (lowest) DSSP energy over acceptor candidates
  // >2 residues away, within 5 A N...O
  auto donor_energy = [&](const HashGrid &grid, Residue &prev, Residue &cur,
                          int cur_uid) {
    Atom *c1 = find_atom(prev, "C"), *o1 = find_atom(prev, "O");
    Atom *n1 = find_atom(cur, "N");
    if (!c1 || !o1 || !n1) return 1e3;
    Vec3 h = n1->pos + unit(c1->pos - o1->pos) * 1.08;
    double best = 1e3;
    grid.neighbors(n1->pos, [&](int j) {
      if (std::abs(all[j].uid - cur_uid) <= 2) return;
      Atom *o2 = find_atom(*all[j].res, "O");
      Atom *c2 = find_atom(*all[j].res, "C");
      if (!o2 || !c2) return;
      if (dist(n1->pos, o2->pos) > 5.0) return;
      double e = dssp_hb_energy(n1->pos, h, o2->pos, c2->pos);
      best = std::min(best, e);
    });
    return best;
  };

  auto rot_peptide = [&](Residue &prev, Residue &cur, double angle) {
    // rotate prev's C and O about the CA(prev)->CA(cur) axis
    Vec3 axis = unit(cur.ca - prev.ca);
    double cs = std::cos(angle), sn = std::sin(angle);
    for (const char *nm : {"C", "O"}) {
      Atom *a = find_atom(prev, nm);
      if (!a) continue;
      Vec3 v = a->pos - prev.ca;
      // Rodrigues rotation
      Vec3 vr = v * cs + cross(axis, v) * sn + axis * (dot(axis, v) * (1 - cs));
      a->pos = prev.ca + vr;
    }
  };

  HBStats st;
  HashGrid grid = acceptor_grid();
  std::vector<std::pair<Residue *, Residue *>> donors;  // (prev, cur)
  std::vector<int> donor_uid;
  {
    int u = 0;
    for (auto &f : frags) {
      for (size_t i = 0; i < f.residues.size(); ++i, ++u)
        if (i > 0 && f.residues[i].res_name != "PRO") {
          donors.emplace_back(&f.residues[i - 1], &f.residues[i]);
          donor_uid.push_back(u);
        }
    }
  }
  for (size_t d = 0; d < donors.size(); ++d) {
    double e = donor_energy(grid, *donors[d].first, *donors[d].second,
                            donor_uid[d]);
    if (e < -0.5) st.before += e;
  }
  for (size_t d = 0; d < donors.size(); ++d) {
    Residue &prev = *donors[d].first, &cur = *donors[d].second;
    double e0 = donor_energy(grid, prev, cur, donor_uid[d]);
    if (e0 >= 1.0) continue;  // no acceptor candidate in range
    double best_e = e0, best_a = 0.0;
    for (int k = -10; k < 10; ++k) {
      double a = 0.1 * k;
      if (k == 0) continue;
      rot_peptide(prev, cur, a);
      double e = donor_energy(grid, prev, cur, donor_uid[d]);
      rot_peptide(prev, cur, -a);
      if (e < best_e) {
        best_e = e;
        best_a = a;
      }
    }
    if (best_a != 0.0 && best_e < e0 - 1e-6) {
      rot_peptide(prev, cur, best_a);
      ++st.improved;
      grid = acceptor_grid();  // O moved; refresh acceptor positions
    }
  }
  for (size_t d = 0; d < donors.size(); ++d) {
    double e = donor_energy(grid, *donors[d].first, *donors[d].second,
                            donor_uid[d]);
    if (e < -0.5) st.after += e;
  }
  return st;
}

// ---------------------------------------------------------------------------

void write_pdb(const std::vector<CAChainFragment> &frags,
               const std::string &path) {
  std::ofstream out(path);
  int serial = 1;
  char last_chain = 0;
  for (const auto &f : frags) {
    for (const auto &r : f.residues) {
      if (last_chain != 0 && r.chain != last_chain) out << "TER\n";
      last_chain = r.chain;
      for (const auto &a : r.atoms) {
        char buf[96];
        std::string nm = a.name.size() < 4 ? " " + a.name : a.name;
        std::snprintf(buf, sizeof(buf),
                      "ATOM  %5d %-4s %3s %c%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                      "          %2c",
                      serial++, nm.c_str(), r.res_name.c_str(), r.chain,
                      r.res_id, a.pos.x, a.pos.y, a.pos.z, a.element);
        out << buf << "\n";
      }
    }
  }
  out << "TER\nEND\n";
}

}  // namespace

int main(int argc, char **argv) {
  bool do_ca_opt = false, do_hb_opt = false;
  double max_shift = 3.0;
  std::vector<std::string> pos;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--ca-optimize") {
      do_ca_opt = true;
    } else if (a == "--hbond-optimize") {
      do_hb_opt = true;
    } else if (a == "--max-shift" && i + 1 < argc) {
      max_shift = std::stod(argv[++i]);
    } else if (a.rfind("--", 0) == 0) {
      std::cerr << "unknown option " << a << "\n";
      return 2;
    } else {
      pos.push_back(a);
    }
  }
  if (pos.size() < 2) {
    std::cerr << "usage: mica_allatom [options] <ca_model.pdb> <out.pdb>\n"
              << "  --ca-optimize     optimize CA positions before rebuild\n"
              << "                    (the reference tool's default mode;\n"
              << "                    MICA's pipeline passes -c to skip it)\n"
              << "  --max-shift F     CA restraint free radius, A (default 3.0)\n"
              << "  --hbond-optimize  refine peptide planes to improve the\n"
              << "                    backbone H-bond pattern (reference -q)\n";
    return 2;
  }
  auto frags = read_ca_pdb(pos[0]);
  if (frags.empty()) {
    std::cerr << "no CA atoms found in " << pos[0] << "\n";
    return 1;
  }
  if (do_ca_opt) {
    CAOptStats st = ca_optimize(frags, max_shift);
    std::cerr << "ca_optimize: energy " << st.e0 << " -> " << st.e1 << " in "
              << st.iters << " iterations\n";
  }
  size_t total = 0;
  for (auto &f : frags) {
    if (f.residues.size() < 1) continue;
    build_backbone(f);
    build_sidechains(f);
    total += f.residues.size();
  }
  if (do_hb_opt) {
    HBStats st = hb_optimize(frags);
    std::cerr << "hb_optimize: bonded energy " << st.before << " -> "
              << st.after << " (" << st.improved << " peptides rotated)\n";
  }
  int d_fixed = chirality_fix(frags);
  relax_clashes(frags);
  write_pdb(frags, pos[1]);
  std::cerr << "rebuilt " << total << " residues in " << frags.size()
            << " fragments (" << d_fixed << " chirality fixes)\n";
  return 0;
}
